"""Distributed bundle adjustment: point-partitioned Schur reduction.

NO reference counterpart (the reference has no BA at all, README.md:42,
and no multi-device code).  This is the driver north star's
"keyframe/map-block partitioned distributed Schur-complement BA with
per-block Hessian reduction across devices":

  * the map (points + their observations) is partitioned across the
    device mesh; cameras are replicated;
  * each device assembles its local U/V/g blocks; camera-side blocks
    reduce across devices with psums;
  * solver="cg" (default): matrix-free Schur CG — each matvec costs
    ONE [M,6] psum (~2 KB) because every point's observations are
    shard-local, so communication is O(M*6*cg_iters) per LM iteration,
    independent of both the point count and M^2;
  * solver="dense": exact replicated [6M,6M] solve, ONE [M,6,M,6] psum
    per LM iteration — fine for small rigs, kept for parity tests;
  * point updates stay local.

Everything runs inside a single `shard_map` whose body scans LM
iterations, so the whole optimization is one XLA program per mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sfm_jax.models import bundle_adjust as ba
from sfm_jax.models.bundle_adjust import BAProblem
from sfm_jax.geometry import lie
from sfm_jax.parallel.mesh import DATA_AXIS
from sfm_jax.utils.precision import f32_matmul


def partition_problem(problem: BAProblem, X, n_shards: int,
                      return_layout: bool = False):
    """Host-side partitioning of points (and their observations) into
    n_shards contiguous blocks, padding both to equal sizes.

    Returns (X_sh [D*Ps, 3] flattened sharded points, prob_sh:
    BAProblem with [D*Os] observation arrays and LOCAL point indices).
    With return_layout=True also returns obs_idx [D*Os] — the ORIGINAL
    observation index per slot (-1 = padding) — so a caller that only
    changed the MASK (e.g. outlier pruning between global-BA rounds)
    can rebuild prob_sh with `mask[obs_idx]` instead of re-running this
    O(D*O) host partition (the layout is mask-independent as long as
    the new mask is a subset of the one partitioned with).
    """
    cam_idx = np.asarray(problem.cam_idx)
    pt_idx = np.asarray(problem.pt_idx)
    uv = np.asarray(problem.uv)
    mask = np.asarray(problem.mask)
    X = np.asarray(X)
    n_pts = X.shape[0]
    ps = -(-n_pts // n_shards)  # points per shard (padded)
    os_counts = []
    shards = []
    for d in range(n_shards):
        lo, hi = d * ps, min((d + 1) * ps, n_pts)
        sel = (pt_idx >= lo) & (pt_idx < hi) & mask
        shards.append(sel)
        os_counts.append(int(sel.sum()))
    os_max = max(1, max(os_counts))
    cam_s = np.zeros((n_shards, os_max), np.int32)
    pt_s = np.zeros((n_shards, os_max), np.int32)
    uv_s = np.zeros((n_shards, os_max, 2), np.float32)
    m_s = np.zeros((n_shards, os_max), bool)
    oi_s = np.full((n_shards, os_max), -1, np.int32)
    X_s = np.zeros((n_shards, ps, 3), np.float32)
    for d, sel in enumerate(shards):
        n = os_counts[d]
        idx = np.nonzero(sel)[0]
        cam_s[d, :n] = cam_idx[idx]
        pt_s[d, :n] = pt_idx[idx] - d * ps  # local point index
        uv_s[d, :n] = uv[idx]
        m_s[d, :n] = True
        oi_s[d, :n] = idx
        lo, hi = d * ps, min((d + 1) * ps, n_pts)
        X_s[d, : hi - lo] = X[lo:hi]
    # Flatten to sharded-leading-dim layout: shard_map splits the first
    # axis across devices, so each device sees [Os] / [Ps, 3] locals.
    prob_s = BAProblem(
        cam_idx=jnp.asarray(cam_s.reshape(-1)),
        pt_idx=jnp.asarray(pt_s.reshape(-1)),
        uv=jnp.asarray(uv_s.reshape(-1, 2)),
        mask=jnp.asarray(m_s.reshape(-1)),
        fixed=problem.fixed,
    )
    if return_layout:
        return jnp.asarray(X_s.reshape(-1, 3)), prob_s, jnp.asarray(
            oi_s.reshape(-1)
        )
    return jnp.asarray(X_s.reshape(-1, 3)), prob_s


def partition_points(X, n_shards: int):
    """Re-slice updated point coordinates into partition_problem's
    layout (contiguous blocks of ceil(P/D), tail-padded)."""
    n_pts = X.shape[0]
    ps = -(-n_pts // n_shards)
    pad = n_shards * ps - n_pts
    return jnp.pad(X, ((0, pad), (0, 0))) if pad else X


def unpartition_points(X_sh, n_pts: int):
    """Undo partition_problem's point layout: the flattened [D*Ps, 3]
    sharded array is the original X padded at the tail."""
    return X_sh[:n_pts]


def _local_blocks(R, t, X_loc, prob_loc: BAProblem, huber_delta, n_cams, n_pts_loc):
    """Per-shard normal-equation blocks (cameras global, points local)."""
    return ba.normal_equation_blocks(
        R, t, X_loc, prob_loc, huber_delta, n_cams, n_pts_loc
    )


def run_dist_ba(R, t, X_sh, prob_sh: BAProblem, mesh: Mesh, *,
                axis: str = DATA_AXIS, **kw):
    """Distributed LM BA over a 1-D mesh.

    Args:
      R, t: camera poses [M, 3, 3], [M, 3]; replicated over the mesh.
      X_sh: [D * Ps, 3] points, sharded on the leading dim.
      prob_sh: BAProblem with [D * Os] observation arrays (sharded),
        LOCAL pt_idx per shard, replicated `fixed`.
      kw: iters, huber_delta, init_lam, solver ("cg", scalable, the
        default; or "dense", exact, small M), cg_iters.

    The arguments are placed on the mesh first, so arrays committed to
    one device (the output of single-device code) are accepted.

    Returns (R, t, X_sh, costs [iters+1]).
    """
    rep = NamedSharding(mesh, P())
    sh = NamedSharding(mesh, P(axis))
    R, t, fixed = jax.device_put((R, t, prob_sh.fixed), rep)
    X_sh, cam, pt, uv, m = jax.device_put(
        (X_sh, prob_sh.cam_idx, prob_sh.pt_idx, prob_sh.uv, prob_sh.mask), sh
    )
    return _run_dist_ba(R, t, X_sh, BAProblem(cam, pt, uv, m, fixed), mesh,
                        axis=axis, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "iters", "huber_delta", "axis", "solver", "cg_iters"),
)
@f32_matmul
def _run_dist_ba(
    R,
    t,
    X_sh,
    prob_sh: BAProblem,
    mesh: Mesh,
    *,
    iters: int = 15,
    huber_delta: float = 3e-3,
    init_lam: float = 1e-3,
    axis: str = DATA_AXIS,
    solver: str = "cg",
    cg_iters: int = 32,
):
    n_cams = R.shape[0]
    dt = R.dtype

    def body(R, t, X_loc, cam_idx, pt_idx, uv, m, fixed):
        # X_loc: [Ps, 3] local shard; obs arrays local.
        prob_loc = BAProblem(cam_idx, pt_idx, uv, m, fixed)
        n_pts_loc = X_loc.shape[0]

        def cost_of(R, t, X_loc):
            c = ba.robust_cost(R, t, X_loc, prob_loc, huber_delta)
            return jax.lax.psum(c, axis)

        def step(carry, _):
            R, t, X_loc, lam, cost = carry
            if solver == "dense":
                U_l, V, Wg, gc_l, gp = _local_blocks(
                    R, t, X_loc, prob_loc, huber_delta, n_cams, n_pts_loc
                )
                U = jax.lax.psum(U_l, axis)
                gc = jax.lax.psum(gc_l, axis)
                dU, dV = ba._damped(U, V, lam)
                Vinv = ba._inv3x3(dV)
                Bv = jnp.einsum("pmix,pxy->pmiy", Wg, Vinv)
                S_cross = jax.lax.psum(
                    jnp.einsum("pmiy,pnjy->minj", Bv, Wg), axis
                )
                rhs_cross = jax.lax.psum(
                    jnp.einsum("pmiy,py->mi", Bv, gp), axis
                )
                M_ = n_cams
                S = -S_cross
                S = S.at[jnp.arange(M_), :, jnp.arange(M_), :].add(dU)
                rhs = gc - rhs_cross
                free = (~fixed).astype(dt)
                S = S * free[:, None, None, None] * free[None, None, :, None]
                S = S.at[jnp.arange(M_), :, jnp.arange(M_), :].add(
                    jnp.eye(6, dtype=dt)[None] * fixed[:, None, None].astype(dt)
                )
                rhs = rhs * free[:, None]
                delta_c = -jnp.linalg.solve(
                    S.reshape(6 * M_, 6 * M_), rhs.reshape(-1)
                ).reshape(M_, 6)
                delta_c = delta_c * free[:, None]
                Wtdc = jnp.einsum("pmiy,mi->py", Wg, delta_c)
                delta_p = -jnp.einsum("pxy,py->px", Vinv, gp + Wtdc)
            else:
                U_l, V, gc_l, gp, Jc_w, _, Jp, r_o, w = ba.weighted_system(
                    R, t, X_loc, prob_loc, huber_delta, n_cams, n_pts_loc
                )
                U = jax.lax.psum(U_l, axis)
                gc = jax.lax.psum(gc_l, axis)
                delta_c, delta_p = ba.schur_solve_cg(
                    U, V, Jc_w, Jp, r_o, w, prob_loc, gc, gp, lam, fixed,
                    cg_iters=cg_iters, psum_axis=axis,
                )
            Rn = jnp.einsum("mij,mjk->mik", R, lie.so3_exp(delta_c[:, :3]))
            tn = t + delta_c[:, 3:]
            Xn = X_loc + delta_p
            c_new = cost_of(Rn, tn, Xn)
            ok = c_new < cost
            R2 = jnp.where(ok, Rn, R)
            t2 = jnp.where(ok, tn, t)
            X2 = jnp.where(ok, Xn, X_loc)
            cost2 = jnp.where(ok, c_new, cost)
            lam2 = jnp.clip(jnp.where(ok, lam * 0.33, lam * 8.0), 1e-9, 1e6)
            return (R2, t2, X2, lam2, cost2), cost2

        c0 = cost_of(R, t, X_loc)
        init = (R, t, X_loc, jnp.asarray(init_lam, dt), c0)
        (Rf, tf, Xf, _, _), costs = jax.lax.scan(step, init, None, length=iters)
        return Rf, tf, Xf, jnp.concatenate([c0[None], costs])

    sharded = P(axis)
    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, sharded, sharded, sharded, sharded, sharded, rep),
        out_specs=(rep, rep, sharded, rep),
        check_vma=False,
    )
    return fn(
        R, t, X_sh,
        prob_sh.cam_idx, prob_sh.pt_idx, prob_sh.uv, prob_sh.mask,
        prob_sh.fixed,
    )
