"""Subprocess worker for the 2-process CPU cluster test
(test_multihost.py).  Forms a real jax.distributed cluster (gloo
collectives over localhost), builds the global mesh through
sfm_jax.parallel.mesh.make_global_mesh, and runs dist_match + dist_BA
end-to-end across process boundaries — the multi-host execution path
that single-process tests cannot reach (SURVEY.md §2.6/§5 distributed
communication backend; no reference counterpart, the reference is
single-GPU src/main.cpp:175).

Usage: python multihost_worker.py PORT PROCESS_ID
"""

import os
import pathlib
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    port, proc_id = sys.argv[1], int(sys.argv[2])
    import numpy as np
    import jax.numpy as jnp

    from sfm_jax.parallel import mesh as meshmod

    n_proc = meshmod.init_distributed(f"localhost:{port}", 2, proc_id)
    assert n_proc == 2, n_proc
    assert jax.device_count() == 4, jax.device_count()
    assert jax.local_device_count() == 2, jax.local_device_count()
    mesh = meshmod.make_global_mesh()
    assert mesh.size == 4, mesh

    from sfm_jax.parallel import dist_ba, dist_match
    from sfm_jax.sift import match as match_mod
    from sfm_jax.models import bundle_adjust as ba

    # Every process seeds the same host rng, so each holds the full
    # problem; put_sharded distributes it over the global mesh.
    rng = np.random.default_rng(0)

    # --- 1. dist match across processes vs the local matcher ---
    n1, n2 = 256, 512
    d1 = rng.normal(size=(n1, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.normal(size=(n2, 128)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = np.ones((n2,), bool)
    best, second, idx = dist_match.dist_match_top2(
        meshmod.put_replicated(mesh, d1),
        meshmod.put_sharded(mesh, d2),
        meshmod.put_sharded(mesh, v2),
        mesh, chunk=128,
    )
    l_best, l_second, l_idx = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), chunk=128
    )
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(l_idx))
    np.testing.assert_allclose(
        np.asarray(best), np.asarray(l_best), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(second), np.asarray(l_second), atol=1e-5
    )

    # --- 2. dist Schur-CG BA across processes ---
    M, n_shards = 6, mesh.size
    Pn, obs_per_cam = 64 * n_shards, 192
    X_gt = rng.uniform([-1, -1, 4], [1, 1, 7], size=(Pn, 3)).astype(np.float32)
    R_gt = np.broadcast_to(np.eye(3, dtype=np.float32), (M, 3, 3)).copy()
    t_gt = np.stack([np.array([0.3 * i, 0, 0], np.float32) for i in range(M)])
    cam_idx = np.repeat(np.arange(M), obs_per_cam).astype(np.int32)
    pt_idx = np.concatenate(
        [rng.choice(Pn, obs_per_cam, replace=False) for _ in range(M)]
    ).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X_gt[pt_idx]) + t_gt[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    prob = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
        jnp.ones(M * obs_per_cam, bool), jnp.asarray(fixed),
    )
    X0 = (X_gt + rng.normal(scale=0.01, size=X_gt.shape)).astype(np.float32)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, n_shards)
    # Multi-host ingest path: each process contributes only ITS local
    # rows (host-major device order keeps a process's shards
    # contiguous), exercising put_local_shards.
    n_local_rows = X_sh.shape[0] // n_proc
    X_loc = np.asarray(X_sh)[proc_id * n_local_rows:(proc_id + 1) * n_local_rows]
    X_glob = meshmod.put_local_shards(mesh, X_loc)
    R_f, t_f, X_f, costs = dist_ba.run_dist_ba(
        meshmod.put_replicated(mesh, np.asarray(R_gt)),
        meshmod.put_replicated(mesh, np.asarray(t_gt)),
        X_glob,
        ba.BAProblem(
            meshmod.put_sharded(mesh, np.asarray(prob_sh.cam_idx)),
            meshmod.put_sharded(mesh, np.asarray(prob_sh.pt_idx)),
            meshmod.put_sharded(mesh, np.asarray(prob_sh.uv)),
            meshmod.put_sharded(mesh, np.asarray(prob_sh.mask)),
            meshmod.put_replicated(mesh, np.asarray(prob_sh.fixed)),
        ),
        mesh, iters=3, solver="cg", cg_iters=8,
    )
    costs = np.asarray(costs)
    assert np.isfinite(costs).all(), costs
    assert costs[-1] < costs[0], costs
    # Deterministic across processes: the parent compares these lines.
    print(f"MULTIHOST_OK cost0={costs[0]:.8e} costF={costs[-1]:.8e}",
          flush=True)


if __name__ == "__main__":
    main()
