"""Tests for the distribution layer on the 8-device virtual CPU mesh:
sharded matching and point-partitioned distributed BA must reproduce
their single-device counterparts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers import rot
from sfm_jax.parallel import mesh as meshmod, dist_ba, dist_match
from sfm_jax.models import bundle_adjust as ba
from sfm_jax.sift import match as match_mod


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshmod.make_mesh(8)


def test_dist_match_equals_local(mesh, rng):
    d1 = rng.normal(size=(100, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.normal(size=(256, 128)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    b_ref, s_ref, i_ref = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2)
    )
    b, s, i = dist_match.dist_match_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.ones((256,), bool), mesh, chunk=32
    )
    np.testing.assert_allclose(np.array(b), np.array(b_ref), atol=1e-6)
    np.testing.assert_array_equal(np.array(i), np.array(i_ref))
    np.testing.assert_allclose(np.array(s), np.array(s_ref), atol=1e-5)


def test_dist_match_bf16_equals_local(mesh, rng):
    """bf16 operands with f32 accumulation: the sharded matcher agrees
    with the local one at the same score product."""
    d1 = rng.normal(size=(64, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.normal(size=(1024, 128)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    b_ref, s_ref, i_ref = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), bf16=True
    )
    b, s, i = dist_match.dist_match_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.ones((1024,), bool), mesh,
        bf16=True,
    )
    np.testing.assert_allclose(np.array(b), np.array(b_ref), atol=2e-3)
    np.testing.assert_array_equal(np.array(i), np.array(i_ref))
    np.testing.assert_allclose(np.array(s), np.array(s_ref), atol=2e-3)


def test_dist_match_respects_validity(mesh, rng):
    d1 = rng.normal(size=(16, 128)).astype(np.float32)
    d2 = np.concatenate([d1, d1 * 0.9])  # best match would be identity
    v2 = np.ones(32, bool)
    v2[:16] = False  # mask out the exact copies
    b, s, i = dist_match.dist_match_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), mesh, chunk=16
    )
    assert (np.array(i) >= 16).all()


def _ba_problem(rng, M=5, P=240):
    X_gt = rng.uniform([-1, -1, 4], [1, 1, 7], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for k in range(M):
        Rk = rot([0, 1, 0], 0.08 * k)
        pos = np.array([0.4 * k, 0, 0])
        Rs.append(Rk)
        ts.append(-Rk @ pos)
    R_gt = np.stack(Rs).astype(np.float32)
    t_gt = np.stack(ts).astype(np.float32)
    cam_idx = np.repeat(np.arange(M), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), M).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X_gt[pt_idx]) + t_gt[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:3] + rng.normal(scale=5e-4, size=(M * P, 2))).astype(
        np.float32
    )
    mask = np.ones(M * P, bool)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    R0 = np.stack(
        [R_gt[k] @ rot(rng.normal(size=3), 0.02 if k else 0) for k in range(M)]
    ).astype(np.float32)
    t0 = (
        t_gt + np.where(np.arange(M)[:, None] > 0, rng.normal(scale=0.03, size=t_gt.shape), 0)
    ).astype(np.float32)
    X0 = (X_gt + rng.normal(scale=0.03, size=X_gt.shape)).astype(np.float32)
    prob = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
        jnp.asarray(mask), jnp.asarray(fixed),
    )
    return prob, R0, t0, X0


def test_dist_ba_matches_single_device(mesh, rng):
    prob, R0, t0, X0 = _ba_problem(rng)
    fin_s, costs_s = ba.run_ba(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0), prob, iters=15
    )
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 8)
    R_d, t_d, X_d, costs_d = dist_ba.run_dist_ba(
        jnp.asarray(R0), jnp.asarray(t0), X_sh, prob_sh, mesh, iters=15
    )
    # Same optimum (f32 reassociation tolerance).
    assert abs(float(costs_d[-1]) - float(costs_s[-1])) < 0.05 * float(costs_s[-1]) + 1e-6
    assert np.abs(np.array(R_d) - np.array(fin_s.R)).max() < 1e-3


def test_dist_ba_cost_monotone(mesh, rng):
    prob, R0, t0, X0 = _ba_problem(rng, M=4, P=160)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 8)
    _, _, _, costs = dist_ba.run_dist_ba(
        jnp.asarray(R0), jnp.asarray(t0), X_sh, prob_sh, mesh, iters=10
    )
    costs = np.array(costs)
    assert np.all(np.diff(costs) <= 1e-6)


def test_partition_problem_roundtrip(rng):
    prob, R0, t0, X0 = _ba_problem(rng, M=3, P=100)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 8)
    # Every original masked observation appears exactly once.
    assert int(np.asarray(prob_sh.mask).sum()) == int(np.asarray(prob.mask).sum())
    ps = X_sh.shape[0] // 8
    # Reconstruct global pt indices and compare uv sets.
    shard_of = np.repeat(np.arange(8), prob_sh.mask.shape[0] // 8)
    gpt = np.asarray(prob_sh.pt_idx) + shard_of * ps
    m = np.asarray(prob_sh.mask)
    orig = {(int(c), int(p)) for c, p in zip(np.asarray(prob.cam_idx), np.asarray(prob.pt_idx))}
    new = {(int(c), int(p)) for c, p in zip(np.asarray(prob_sh.cam_idx)[m], gpt[m])}
    assert orig == new


def test_dist_ba_dense_solver_matches_cg(mesh):
    # Both distributed solvers must land at the same optimum; dense
    # psums [M,6,M,6] once per LM iter, CG psums [M,6] per matvec.
    rng2 = np.random.default_rng(5)
    prob, R0, t0, X0 = _ba_problem(rng2)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 8)
    args = (jnp.asarray(R0), jnp.asarray(t0), X_sh, prob_sh, mesh)
    _, _, _, c_cg = dist_ba.run_dist_ba(*args, iters=12, solver="cg")
    _, _, _, c_de = dist_ba.run_dist_ba(*args, iters=12, solver="dense")
    assert float(c_cg[-1]) < float(c_cg[0]) * 0.1
    assert abs(float(c_cg[-1]) - float(c_de[-1])) < 0.1 * float(c_de[-1]) + 1e-6


def test_gather_to_one_takes_device0_copy_and_gathers_shards(mesh):
    """Replicated leaves whose per-device copies differ (as GPU
    scatter-adds can make them) come back as device 0's copy; sharded
    leaves come back whole; both on one device."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(x):
        me = jax.lax.axis_index(meshmod.DATA_AXIS).astype(jnp.float32)
        return jnp.full((3,), me), x * 2.0

    drifted, sharded = jax.jit(shard_map(
        body, mesh=mesh, in_specs=P(meshmod.DATA_AXIS),
        out_specs=(P(), P(meshmod.DATA_AXIS)), check_vma=False,
    ))(jnp.arange(16.0))
    one, whole = meshmod.gather_to_one((drifted, sharded), mesh)
    dev0 = mesh.devices.flat[0]
    assert one.sharding.device_set == {dev0}
    assert whole.sharding.device_set == {dev0}
    np.testing.assert_array_equal(np.asarray(one), np.zeros(3))
    np.testing.assert_array_equal(np.asarray(whole), np.arange(16.0) * 2.0)
