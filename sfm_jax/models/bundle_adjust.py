"""Sparse Levenberg-Marquardt bundle adjustment with Schur complement.

NO reference counterpart — the reference explicitly lacks BA
("Bundle adjustment would solve this but is way outside the scope",
reference README.md:42).  This is the north-star extension (BASELINE.json config 4/5),
designed for an accelerator:

  * static shapes everywhere: fixed camera/point/observation capacities
    with masks, LM iterations under `lax.scan` with branchless
    accept/reject;
  * per-observation 2x6 / 2x3 Jacobian blocks via forward-mode autodiff
    (vmapped jacfwd = 9 JVPs over all observations at once);
  * block Hessian assembly via segment scatter-adds (U [M,6,6],
    V [P,3,3], W grouped per (point, camera));
  * Schur complement S = U - W V^-1 W^T reduced via one einsum over
    the point dimension; closed-form batched 3x3 inverses;
  * dense symmetric solve of the reduced [6M, 6M] camera system;
  * robust Huber reweighting.

The observation layout (cam_idx, pt_idx, uv) is the same one the
distributed version shards over devices, with U/S/rhs reduced by psum
(see sfm_jax.parallel.dist_ba).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.geometry import lie
from sfm_jax.utils.precision import f32_matmul


def auto_solver(n_cams: int, n_pts: int) -> str:
    """run_ba's "auto": dense while Wg fits, CG beyond, on any device."""
    return "dense" if n_cams * n_pts <= 8_000_000 else "cg"


class BAProblem(NamedTuple):
    """Static-shape BA problem.  uv are NORMALIZED image coordinates
    (K^-1 applied), so the camera model is pure (R, t)."""

    cam_idx: jax.Array   # [O] int32
    pt_idx: jax.Array    # [O] int32
    uv: jax.Array        # [O, 2] normalized observations
    mask: jax.Array      # [O] bool (padding/outlier mask)
    fixed: jax.Array     # [M] bool — cameras excluded from updates (gauge)


class BAState(NamedTuple):
    R: jax.Array         # [M, 3, 3]
    t: jax.Array         # [M, 3]
    X: jax.Array         # [P, 3]
    lam: jax.Array       # LM damping
    cost: jax.Array      # current robust cost


def _residuals(R, t, X, problem: BAProblem):
    """[O, 2] reprojection residuals (normalized plane)."""
    Ri = R[problem.cam_idx]
    ti = t[problem.cam_idx]
    Xj = X[problem.pt_idx]
    Xc = jnp.einsum("oij,oj->oi", Ri, Xj) + ti
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    pred = Xc[..., :2] / z_safe[..., None]
    r = pred - problem.uv
    return jnp.where(problem.mask[:, None], r, 0.0)


def _huber_w(rnorm2, delta):
    """IRLS weights for the Huber loss on residual norm."""
    rn = jnp.sqrt(jnp.maximum(rnorm2, 1e-24))
    return jnp.where(rn <= delta, 1.0, delta / rn)


def robust_cost(R, t, X, problem: BAProblem, delta):
    r = _residuals(R, t, X, problem)
    rn2 = jnp.sum(r * r, axis=-1)
    rn = jnp.sqrt(jnp.maximum(rn2, 1e-24))
    c = jnp.where(rn <= delta, 0.5 * rn2, delta * (rn - 0.5 * delta))
    return jnp.sum(jnp.where(problem.mask, c, 0.0))


def _obs_jacobians(R, t, X, problem: BAProblem):
    """Per-observation Jacobians wrt (camera 6-dof, point 3-dof).

    Camera tangent: [dr (so3, right-multiplied), dt]; point tangent: dX.
    Returns (r [O,2], Jc [O,2,6], Jp [O,2,3]).
    """
    Ri = R[problem.cam_idx]
    ti = t[problem.cam_idx]
    Xj = X[problem.pt_idx]

    def obs_res(dcam, dpt, Ri, ti, Xj, uv):
        Rn = Ri @ lie.so3_exp(dcam[:3])
        tn = ti + dcam[3:]
        Xn = Xj + dpt
        Xc = Rn @ Xn + tn
        z = Xc[2]
        z_safe = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
        return Xc[:2] / z_safe - uv

    zero6 = jnp.zeros((problem.uv.shape[0], 6), R.dtype)
    zero3 = jnp.zeros((problem.uv.shape[0], 3), R.dtype)
    r = jax.vmap(obs_res)(zero6, zero3, Ri, ti, Xj, problem.uv)
    Jc = jax.vmap(jax.jacfwd(obs_res, argnums=0))(zero6, zero3, Ri, ti, Xj, problem.uv)
    Jp = jax.vmap(jax.jacfwd(obs_res, argnums=1))(zero6, zero3, Ri, ti, Xj, problem.uv)
    m = problem.mask[:, None]
    return jnp.where(m, r, 0.0), Jc * m[..., None], Jp * m[..., None]


def _inv3x3(A):
    """Closed-form batched 3x3 inverse via adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def weighted_system(R, t, X, problem: BAProblem, huber_delta, n_cams, n_pts):
    """Robust-weighted GN system pieces shared by both solvers.

    Returns (U [M,6,6], V [P,3,3], gc [M,6], gp [P,3],
    Jc_w [O,2,6] (Huber-weighted camera Jacobians), Jc, Jp, r, w).
    """
    r, Jc, Jp = _obs_jacobians(R, t, X, problem)
    w = _huber_w(jnp.sum(r * r, axis=-1), huber_delta) * problem.mask
    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]
    U = jnp.zeros((n_cams, 6, 6), R.dtype).at[problem.cam_idx].add(
        jnp.einsum("oai,oaj->oij", Jc_w, Jc)
    )
    V = jnp.zeros((n_pts, 3, 3), R.dtype).at[problem.pt_idx].add(
        jnp.einsum("oai,oaj->oij", Jp_w, Jp)
    )
    gc = jnp.zeros((n_cams, 6), R.dtype).at[problem.cam_idx].add(
        jnp.einsum("oai,oa->oi", Jc_w, r)
    )
    gp = jnp.zeros((n_pts, 3), R.dtype).at[problem.pt_idx].add(
        jnp.einsum("oai,oa->oi", Jp_w, r)
    )
    return U, V, gc, gp, Jc_w, Jc, Jp, r, w


def normal_equation_blocks(R, t, X, problem: BAProblem, huber_delta, n_cams, n_pts):
    """Assemble masked robust GN blocks (dense path, small M).

    Returns (U [M,6,6], V [P,3,3], Wg [P,M,6,3] grouped cross blocks,
    gc [M,6], gp [P,3]).  Wg is dense in M — use the CG path
    (schur_solve_cg) beyond ~16 cameras.
    """
    U, V, gc, gp, Jc_w, _, Jp, _, _ = weighted_system(
        R, t, X, problem, huber_delta, n_cams, n_pts
    )
    W_obs = jnp.einsum("oai,oaj->oij", Jc_w, Jp)  # [O, 6, 3]
    Wg = jnp.zeros((n_pts, n_cams, 6, 3), R.dtype).at[
        problem.pt_idx, problem.cam_idx
    ].add(W_obs)
    return U, V, Wg, gc, gp


def _damped(U, V, lam):
    """LM damping (multiplicative on diagonals + small absolute floor)."""
    dt = U.dtype
    dU = U + (lam * jnp.eye(6, dtype=dt))[None] * (
        jnp.trace(U, axis1=-2, axis2=-1)[:, None, None] / 6.0 + 1e-6
    )
    dV = V + (lam * jnp.eye(3, dtype=dt))[None] * (
        jnp.trace(V, axis1=-2, axis2=-1)[:, None, None] / 3.0 + 1e-6
    )
    return dU, dV


def schur_solve_cg(
    U, V, Jc_w, Jp, r, w, problem: BAProblem, gc, gp, lam, fixed,
    *, cg_iters: int = 32, psum_axis: str | None = None,
):
    """Matrix-free damped Schur solve via preconditioned CG.

    Never materializes S (the dense path's [M,6,M,6]) or the grouped
    cross blocks Wg (the dense path's [P,M,6,3]): every S-product is
    two observation-space einsums + segment adds, so memory is
    O(O*2*9) and compute is O(O) per CG step — this is what lets BA
    run at hundreds of cameras / 100k points on one chip and shard
    across a mesh.  When called inside shard_map with `psum_axis`, the
    layout contract is: cameras replicated, points partitioned WITH all
    of their observations shard-local (parallel.dist_ba.partition_problem
    guarantees this) — then only the camera-side segment sums cross devices,
    ONE [M,6] psum per matvec (~2 KB), vs the dense path's [M,6,M,6].

    Gauge handling matches the dense path: fixed cameras get identity
    rows (delta forced to 0).  Returns (delta_cam [M,6], delta_pt [P,3]).
    """
    M = U.shape[0]
    dt = U.dtype
    dU, dV = _damped(U, V, lam)
    Vinv = _inv3x3(dV)  # [P,3,3]
    free = (~fixed).astype(dt)  # [M]
    cam = problem.cam_idx
    pt = problem.pt_idx
    n_pts = V.shape[0]
    Jp_w = Jp * w[:, None, None]

    def seg_pt(vals):  # [O,3] -> [P,3]; always shard-local (see contract)
        return jnp.zeros((n_pts, 3), dt).at[pt].add(vals)

    def seg_cam(vals):  # [O,6] -> [M,6]
        out = jnp.zeros((M, 6), dt).at[cam].add(vals)
        if psum_axis is not None:
            out = jax.lax.psum(out, psum_axis)
        return out

    def WT_v(v):  # [M,6] -> [P,3]   (W^T v, W_o = Jc_w^T Jp)
        a = jnp.einsum("oai,oi->oa", Jc_w, v[cam])  # [O,2]
        return seg_pt(jnp.einsum("oaj,oa->oj", Jp, a))

    def W_z(z):  # [P,3] -> [M,6]
        c = jnp.einsum("oaj,oj->oa", Jp, z[pt])     # [O,2]
        return seg_cam(jnp.einsum("oai,oa->oi", Jc_w, c))

    def S_mul(v):
        v = v * free[:, None]
        y = WT_v(v)
        z = jnp.einsum("pxy,py->px", Vinv, y)
        out = jnp.einsum("mij,mj->mi", dU, v) - W_z(z)
        # Identity rows for fixed cameras keep S positive definite.
        return out * free[:, None] + v * (1.0 - free)[:, None]

    # rhs = gc - W Vinv gp  (gauge rows zeroed)
    rhs = (gc - W_z(jnp.einsum("pxy,py->px", Vinv, gp))) * free[:, None]

    # Block-Jacobi preconditioner from the damped camera blocks.
    Uinv = jnp.linalg.inv(
        dU + jnp.eye(6, dtype=dt)[None] * 1e-8
    )

    def precond(v):
        return jnp.einsum("mij,mj->mi", Uinv, v) * free[:, None]

    x0 = jnp.zeros_like(rhs)
    r0 = rhs  # S x0 = 0
    z0 = precond(r0)

    def cg_step(carry, _):
        x, rr, z, p, rz = carry
        Sp = S_mul(p)
        pSp = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(pSp) < 1e-30, 1e-30, pSp)
        x_n = x + alpha * p
        r_n = rr - alpha * Sp
        z_n = precond(r_n)
        rz_n = jnp.sum(r_n * z_n)
        beta = rz_n / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p_n = z_n + beta * p
        return (x_n, r_n, z_n, p_n, rz_n), None

    init = (x0, r0, z0, z0, jnp.sum(r0 * z0))
    (xc, *_), _ = jax.lax.scan(cg_step, init, None, length=cg_iters)
    delta_c = -xc * free[:, None]
    # Back-substitute points: dp = -Vinv (gp + W^T dc).
    Wtdc = WT_v(delta_c)
    delta_p = -jnp.einsum("pxy,py->px", Vinv, gp + Wtdc)
    return delta_c, delta_p


def schur_solve(U, V, Wg, gc, gp, lam, fixed):
    """Damped Schur-complement solve.

    Returns (delta_cam [M,6], delta_pt [P,3]).
    """
    M = U.shape[0]
    dt = U.dtype
    dU, dV = _damped(U, V, lam)
    Vinv = _inv3x3(dV)                                   # [P,3,3]
    Bv = jnp.einsum("pmix,pxy->pmiy", Wg, Vinv)          # [P,M,6,3]
    # S = blockdiag(dU) - sum_p Bv W^T   -> [M,6,M,6]
    S = -jnp.einsum("pmiy,pnjy->minj", Bv, Wg)
    S = S.at[jnp.arange(M), :, jnp.arange(M), :].add(dU)
    rhs = gc - jnp.einsum("pmiy,py->mi", Bv, gp)         # [M,6]
    # Gauge fixing: zero out rows/cols of fixed cameras, identity diag.
    free = (~fixed).astype(dt)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S.at[jnp.arange(M), :, jnp.arange(M), :].add(
        jnp.eye(6, dtype=dt)[None] * fixed[:, None, None].astype(dt)
    )
    rhs = rhs * free[:, None]
    Sm = S.reshape(6 * M, 6 * M)
    delta_c = -jnp.linalg.solve(Sm, rhs.reshape(-1)).reshape(M, 6)
    delta_c = delta_c * free[:, None]
    # Back-substitute points: dp = -Vinv (gp + W^T dc)
    Wtdc = jnp.einsum("pmiy,mi->py", Wg, delta_c)        # [P,3]
    delta_p = -jnp.einsum("pxy,py->px", Vinv, gp + Wtdc)
    return delta_c, delta_p


def _apply(R, t, X, delta_c, delta_p):
    Rn = jnp.einsum("mij,mjk->mik", R, lie.so3_exp(delta_c[:, :3]))
    tn = t + delta_c[:, 3:]
    Xn = X + delta_p
    return Rn, tn, Xn


@functools.partial(
    jax.jit, static_argnames=("iters", "huber_delta", "solver", "cg_iters")
)
@f32_matmul
def run_ba(
    R,
    t,
    X,
    problem: BAProblem,
    *,
    iters: int = 20,
    huber_delta: float = 3e-3,
    init_lam: float = 1e-3,
    solver: str = "auto",
    cg_iters: int = 32,
):
    """LM bundle adjustment; returns final BAState and per-iter costs.

    solver: "dense" (exact [6M,6M] Schur solve; materializes the
    grouped cross blocks Wg [P,M,6,3]), "cg" (matrix-free
    preconditioned CG on the Schur complement — O(O) memory, scales to
    any M*P and shards across a mesh), or "auto".

    "auto" picks dense while the grouped cross blocks Wg fit
    (n_cams * n_pts <= 8M, ~0.6 GB of Wg) and CG beyond.  Dense is an
    exact pivoted-LU solve (LAPACK on the CPU, cuSOLVER on the GPU);
    chip_smoke.py checks on the card that it lands where CG and the
    CPU do on a gauge-degenerate problem (no camera held fixed).
    """
    n_cams = R.shape[0]
    n_pts = X.shape[0]
    if solver == "auto":
        solver = auto_solver(n_cams, n_pts)
    c0 = robust_cost(R, t, X, problem, huber_delta)

    def step(state: BAState, _):
        R, t, X, lam, cost = state
        if solver == "dense":
            U, V, Wg, gc, gp = normal_equation_blocks(
                R, t, X, problem, huber_delta, n_cams, n_pts
            )
            dc, dp = schur_solve(U, V, Wg, gc, gp, lam, problem.fixed)
        else:
            U, V, gc, gp, Jc_w, _, Jp, r, w = weighted_system(
                R, t, X, problem, huber_delta, n_cams, n_pts
            )
            dc, dp = schur_solve_cg(
                U, V, Jc_w, Jp, r, w, problem, gc, gp, lam, problem.fixed,
                cg_iters=cg_iters,
            )
        Rn, tn, Xn = _apply(R, t, X, dc, dp)
        c_new = robust_cost(Rn, tn, Xn, problem, huber_delta)
        ok = c_new < cost
        R = jnp.where(ok, Rn, R)
        t = jnp.where(ok, tn, t)
        X = jnp.where(ok, Xn, X)
        cost = jnp.where(ok, c_new, cost)
        lam = jnp.clip(jnp.where(ok, lam * 0.33, lam * 8.0), 1e-9, 1e6)
        return BAState(R, t, X, lam, cost), cost

    init = BAState(R, t, X, jnp.asarray(init_lam, R.dtype), c0)
    final, costs = jax.lax.scan(step, init, None, length=iters)
    return final, jnp.concatenate([c0[None], costs])
