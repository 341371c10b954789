"""Perspective-n-Point camera registration (DLT + RANSAC + GN refine).

NO reference counterpart — the reference is strictly two-view (survey
§2/§7; multi-view registration is the north-star extension, driver
config 3).  Design mirrors the essential-matrix stack: batched DLT over
minimal sets (vmapped null-space solves), vectorized hypothesis
scoring by reprojection error, branchless argmax winner, all-inlier
refit, and fixed-iteration Gauss-Newton polish on SE(3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.geometry import lie
from sfm_jax.utils.precision import f32_matmul


class PnPResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    inliers: jax.Array
    num_inliers: jax.Array


def _dlt_rows(x, X):
    """[..., N, 2, 12] DLT constraint rows for x ~ P [X; 1].

    Row pair per point: [X 1 0 0 -u(X 1); 0 0 X 1 -v(X 1)] with
    normalized image coords (u, v) = x[..., :2] / x[..., 2].
    """
    u = x[..., 0] / x[..., 2]
    v = x[..., 1] / x[..., 2]
    Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)  # [..., N, 4]
    z = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z, -u[..., None] * Xh], axis=-1)
    r2 = jnp.concatenate([z, Xh, -v[..., None] * Xh], axis=-1)
    return jnp.stack([r1, r2], axis=-2)  # [..., N, 2, 12]


def pnp_dlt(x, X, weights=None):
    """Direct linear PnP from [..., N, 3] obs and [..., N, 3] points.

    Returns (R [..., 3, 3], t [..., 3]).  Uses the weighted Gram
    null-space (N >= 6); callers should pre-normalize coordinates for
    conditioning (ransac_pnp does).
    """
    A = _dlt_rows(x, X)
    A = A.reshape(*A.shape[:-3], -1, 12)  # [..., 2N, 12]
    if weights is not None:
        w2 = jnp.repeat(weights, 2, axis=-1)
        G = jnp.einsum("...ni,...n,...nj->...ij", A, w2, A)
    else:
        G = jnp.einsum("...ni,...nj->...ij", A, A)
    # Ridge inverse iteration instead of the 12x12 Jacobi: the Jacobi
    # chain is 10 sweeps x 66 rotations of sequential VPU ops (latency-
    # bound even batched over a hypothesis bank); this is 8 batched
    # 12x12 solves.  The DLT null space is well separated for both
    # minimal sets and all-inlier refits.
    p = linalg.smallest_eigvec_power(G, iters=8)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :, :3]
    # Fix global sign so that det(M) > 0 (proper rotation).
    sgn = jnp.sign(jnp.linalg.det(M))
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    P = P * sgn[..., None, None]
    M = P[..., :, :3]
    # Scale: rotation has unit singular values.
    _, s, _ = linalg.svd3x3(M)
    scale = jnp.mean(s, axis=-1)
    R = linalg.so3_project(M / jnp.maximum(scale, 1e-12)[..., None, None])
    t = P[..., :, 3] / jnp.maximum(scale, 1e-12)[..., None]
    return R, t


def reprojection_residuals(R, t, x, X):
    """[..., N] squared reprojection errors in the normalized plane."""
    Xc = jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    pred = Xc[..., :2] / z_safe[..., None]
    obs = x[..., :2] / x[..., 2:3]
    d = jnp.sum((pred - obs) ** 2, axis=-1)
    # Points behind the camera are always wrong.
    return jnp.where(z > 0, d, 1e6)


@functools.partial(jax.jit, static_argnames=("iters",))
@f32_matmul
def refine_pose(R, t, x, X, weights=None, *, iters: int = 8,
                huber_delta: float = 3e-3):
    """Fixed-iteration damped GN on SE(3) minimizing robust reprojection."""
    n = x.shape[0]
    w_in = jnp.ones((n,), x.dtype) if weights is None else weights.astype(x.dtype)
    obs = x[..., :2] / x[..., 2:3]

    def residuals(params, R0, t0):
        Rn = R0 @ lie.so3_exp(params[:3])
        tn = t0 + params[3:]
        Xc = jnp.einsum("ij,nj->ni", Rn, X) + tn
        z = Xc[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
        return (Xc[..., :2] / z_safe[..., None] - obs).reshape(-1)

    def cost_of(r):
        r2 = r.reshape(-1, 2)
        rn2 = jnp.sum(r2 * r2, axis=-1)
        rn = jnp.sqrt(jnp.maximum(rn2, 1e-24))
        d = huber_delta
        c = jnp.where(rn <= d, 0.5 * rn2, d * (rn - 0.5 * d))
        return jnp.sum(c * w_in)

    def step(carry, _):
        R0, t0, lam = carry
        zero = jnp.zeros((6,), x.dtype)
        r = residuals(zero, R0, t0)
        J = jax.jacfwd(residuals)(zero, R0, t0)  # [2N, 6]
        rn = jnp.sqrt(jnp.maximum(jnp.sum(r.reshape(-1, 2) ** 2, -1), 1e-24))
        hw = jnp.where(rn <= huber_delta, 1.0, huber_delta / rn)
        w = jnp.repeat(w_in * hw, 2)
        H = (J.T * w) @ J
        g = (J.T * w) @ r
        H = H + lam * jnp.eye(6, dtype=x.dtype) * jnp.maximum(jnp.trace(H) / 6.0, 1e-10)
        delta = -jnp.linalg.solve(H, g)
        r_new = residuals(delta, R0, t0)
        ok = cost_of(r_new) < cost_of(r)
        Rn = R0 @ lie.so3_exp(jnp.where(ok, delta[:3], 0.0))
        tn = t0 + jnp.where(ok, delta[3:], 0.0)
        lam = jnp.clip(jnp.where(ok, lam * 0.33, lam * 8.0), 1e-10, 1e4)
        return (Rn, tn, lam), None

    (Rf, tf, _), _ = jax.lax.scan(
        step, (R, t, jnp.asarray(1e-4, x.dtype)), None, length=iters
    )
    return Rf, tf


@functools.partial(jax.jit, static_argnames=("n_hyps", "refine_iters"))
@f32_matmul
def ransac_pnp(
    key,
    x,
    X,
    mask=None,
    *,
    n_hyps: int = 512,
    threshold: float = 4e-6,
    refine_iters: int = 8,
    R_init=None,
    t_init=None,
) -> PnPResult:
    """Robust PnP from [N, 3] normalized obs and [N, 3] world points."""
    n = x.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)

    # Condition: center/scale 3D points; image coords are already
    # normalized-camera (O(1)).
    w = mask.astype(x.dtype)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    c3 = jnp.sum(X * w[:, None], axis=0) / wsum
    scale3 = jnp.sum(jnp.linalg.norm(X - c3, axis=-1) * w) / wsum
    scale3 = jnp.maximum(scale3, 1e-3)
    Xn = (X - c3) / scale3

    # Sample minimal 6-point sets (distinct indices; Floyd sampling
    # shared with the essential-matrix RANSAC).
    from sfm_jax.geometry.ransac import sample_minimal_sets

    idx = sample_minimal_sets(key, mask, n_hyps, k=6)

    R_bank, t_bank = pnp_dlt(x[idx], Xn[idx])
    r = reprojection_residuals(R_bank, t_bank, x, Xn)  # [H, N]
    counts = jnp.sum((r < threshold) & mask[None, :], axis=-1)
    best = jnp.argmax(counts)
    R0, t0 = R_bank[best], t_bank[best]

    # Optional externally-seeded hypothesis (e.g. the previous frame's
    # pose in incremental SfM): minimal 6-point DLT sets are unstable
    # on shallow/far geometry, and a motion prior is frequently better
    # than every sampled hypothesis.  Compared at a WIDE gate so an
    # approximately-right prior can win the LO start even when its
    # strict-inlier count is small.
    if R_init is not None:
        t_cond = (R_init @ c3 + t_init) / scale3  # conditioned frame
        r_init = reprojection_residuals(R_init, t_cond, x, Xn)
        wide = threshold * 16
        c_init = jnp.sum((r_init < wide) & mask)
        c_best = jnp.sum(
            (reprojection_residuals(R0, t0, x, Xn) < wide) & mask
        )
        take = c_init > c_best
        R0 = jnp.where(take, R_init, R0)
        t0 = jnp.where(take, t_cond, t0)

    # LO-RANSAC: iterate (all-inlier DLT refit -> GN polish -> recount),
    # keeping the best model so far.  A single polish round left PnP at
    # the mercy of the minimal-sample draw (r1: 30..159 inliers across
    # seeds on the same dino problem); three rounds converge reliably.
    def lo_round(carry, gate_mult):
        R_best, t_best, c_best = carry
        r_cur = reprojection_residuals(R_best, t_best, x, Xn)
        w = ((r_cur < threshold * gate_mult) & mask).astype(x.dtype)
        # GN-polish the CURRENT model on its wide-gate support, then
        # DLT-refit from scratch on the same support; keep whichever
        # (or the incumbent) scores most strict inliers.
        R1, t1 = refine_pose(R_best, t_best, x, Xn, w, iters=refine_iters)
        R2, t2 = pnp_dlt(x, Xn, weights=w)
        R2, t2 = refine_pose(R2, t2, x, Xn, w, iters=refine_iters)
        c1 = jnp.sum(
            (reprojection_residuals(R1, t1, x, Xn) < threshold) & mask
        ).astype(jnp.int32)
        c2 = jnp.sum(
            (reprojection_residuals(R2, t2, x, Xn) < threshold) & mask
        ).astype(jnp.int32)
        take2 = c2 >= c1
        R1 = jnp.where(take2, R2, R1)
        t1 = jnp.where(take2, t2, t1)
        c1 = jnp.maximum(c1, c2)
        better = c1 > c_best
        return (
            jnp.where(better, R1, R_best),
            jnp.where(better, t1, t_best),
            jnp.where(better, c1, c_best),
        ), None

    c0 = jnp.sum(
        (reprojection_residuals(R0, t0, x, Xn) < threshold) & mask
    ).astype(jnp.int32)
    # Annealed gates: a wide first round lets an approximate start
    # capture its support before the tighter rounds converge it.
    gates = jnp.asarray([16.0, 4.0, 4.0], x.dtype)
    (Rf, tf, _), _ = jax.lax.scan(lo_round, (R0, t0, c0), gates)

    r_fin = reprojection_residuals(Rf, tf, x, Xn)
    inl = (r_fin < threshold) & mask
    # De-condition: x ~ R (X-c3)/s + t  =>  t_world = s*t - R c3 ... in
    # the same projective class: R X + (s t - R c3) projects equally.
    t_world = scale3 * tf - Rf @ c3
    return PnPResult(
        R=Rf, t=t_world, inliers=inl,
        num_inliers=jnp.sum(inl).astype(jnp.int32),
    )
