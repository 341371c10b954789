"""Self-calibrating bundle adjustment: shared focal + radial distortion.

NO reference counterpart — the reference hard-codes K
(reference src/main.cpp:292-297) and has no distortion model at all.
This module exists because the canonical dino turntable data is NOT
distortion-free: with the pinhole-only model the narrow-FOV (~17 deg)
sequence collapses into the bas-relief ambiguity (recovered turntable
steps ~4.5 deg instead of ~9.7; r2 measurement, and reproduced exactly
on synthetic data by adding k1 distortion — see
tests/test_calibrate.py).

Model: pixel = c + f * x_n * (1 + k1 r^2 + k2 r^4), r^2 = |x_n|^2,
with shared (f, k1, k2) across all cameras and fixed principal point.

Accelerator-first design: block coordinate descent keeps every piece a
fixed-shape jitted program —

  1. the existing Schur-complement LM BA over (R, t, X) on
     NORMALIZED observations (models.bundle_adjust, unchanged);
  2. a CLOSED-FORM weighted linear fit of (f, f*k1, f*k2) given the
     current structure: the predicted pixel is linear in those three
     parameters, so the update is one masked 3x3 normal solve — no
     extra Jacobian columns, no bordered Schur system;
  3. observation re-normalization by fixed-point undistortion
     (5 iterations, branchless).

Alternating 2-3 rounds converges for the few-parameter intrinsics
block (it is near-orthogonal to structure once poses are roughly
right), and each round reuses the SAME compiled BA program because
shapes never change.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.models import bundle_adjust as ba
from sfm_jax.utils.precision import f32_matmul


class Intrinsics(NamedTuple):
    f: jax.Array    # [] shared focal (pixels)
    cx: jax.Array   # [] principal point (fixed, not estimated)
    cy: jax.Array
    k1: jax.Array   # [] radial distortion (normalized-radius poly)
    k2: jax.Array


def intrinsics_from_K(K, k1=0.0, k2=0.0) -> Intrinsics:
    K = jnp.asarray(K)
    return Intrinsics(
        f=K[0, 0], cx=K[0, 2], cy=K[1, 2],
        k1=jnp.asarray(k1, K.dtype), k2=jnp.asarray(k2, K.dtype),
    )


def distort(xn, intr: Intrinsics):
    """Normalized -> distorted normalized: x_d = x_n (1 + k1 r^2 + k2 r^4)."""
    r2 = jnp.sum(xn * xn, axis=-1, keepdims=True)
    return xn * (1.0 + intr.k1 * r2 + intr.k2 * r2 * r2)


def project_pixels(xn, intr: Intrinsics):
    """Normalized coords -> pixel coords under the distortion model."""
    xd = distort(xn, intr)
    c = jnp.stack([intr.cx, intr.cy])
    return xd * intr.f + c


def undistort_normalize(uv_pix, intr: Intrinsics, iters: int = 5):
    """Pixel observations -> undistorted NORMALIZED coords [.., 2].

    Fixed-point inversion of the distortion polynomial (branchless,
    `iters` unrolled steps — the standard contraction for |k1| r^2 < 1).
    """
    c = jnp.stack([intr.cx, intr.cy])
    xd = (uv_pix - c) / intr.f
    xn = xd
    for _ in range(iters):
        r2 = jnp.sum(xn * xn, axis=-1, keepdims=True)
        denom = 1.0 + intr.k1 * r2 + intr.k2 * r2 * r2
        denom = jnp.where(jnp.abs(denom) < 0.25, 0.25, denom)
        xn = xd / denom
    return xn


@jax.jit
@f32_matmul
def fit_intrinsics(R, t, X, cam_idx, pt_idx, mask, uv_pix, intr: Intrinsics,
                   w=None) -> Intrinsics:
    """Closed-form weighted LS update of (f, k1, k2), fixed structure.

    pixel - c = f*x_n + (f*k1)*(x_n r^2) + (f*k2)*(x_n r^4) is LINEAR
    in theta = (f, f*k1, f*k2): one masked 3x3 normal solve over all
    observations.  Falls back to the input intrinsics if the system is
    ill-conditioned (e.g. no distortion diversity yet).
    """
    Xc = jnp.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
    z = Xc[..., 2:3]
    z = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    xn = Xc[..., :2] / z                              # [O, 2] predicted
    r2 = jnp.sum(xn * xn, axis=-1, keepdims=True)
    c = jnp.stack([intr.cx, intr.cy])
    b = uv_pix - c                                    # [O, 2]
    A = jnp.stack([xn, xn * r2, xn * r2 * r2], -1)    # [O, 2, 3]
    m = mask.astype(xn.dtype)[:, None, None]
    if w is not None:
        m = m * w[:, None, None]
    G = jnp.einsum("oxi,oxj->ij", A * m, A)           # [3, 3]
    rhs = jnp.einsum("oxi,ox->i", A * m, b)
    theta = jnp.linalg.solve(G + 1e-8 * jnp.eye(3, dtype=G.dtype), rhs)
    f_new = theta[0]
    ok = jnp.isfinite(f_new) & (f_new > 0.05 * intr.f) & (f_new < 20.0 * intr.f)
    f_new = jnp.where(ok, f_new, intr.f)
    k1 = jnp.where(ok, theta[1] / f_new, intr.k1)
    k2 = jnp.where(ok, theta[2] / f_new, intr.k2)
    return Intrinsics(f=f_new, cx=intr.cx, cy=intr.cy, k1=k1, k2=k2)


def _obs_jacobians_intr(R, t, X, cam_idx, pt_idx, mask, uv_pix, intr):
    """Per-observation PIXEL residuals + Jacobians wrt camera (6),
    point (3), and global intrinsics theta = (f, k1, k2)."""
    from sfm_jax.geometry import lie

    Ri = R[cam_idx]
    ti = t[cam_idx]
    Xj = X[pt_idx]
    c = jnp.stack([intr.cx, intr.cy])
    th0 = jnp.stack([intr.f, intr.k1, intr.k2])

    def obs_res(dcam, dpt, dth, Ri, ti, Xj, uv):
        Rn = Ri @ lie.so3_exp(dcam[:3])
        tn = ti + dcam[3:]
        Xc = Rn @ (Xj + dpt) + tn
        z = Xc[2]
        z = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
        xn = Xc[:2] / z
        f, k1, k2 = th0[0] + dth[0], th0[1] + dth[1], th0[2] + dth[2]
        r2 = jnp.sum(xn * xn)
        return c + f * xn * (1.0 + k1 * r2 + k2 * r2 * r2) - uv

    O = uv_pix.shape[0]
    z6 = jnp.zeros((O, 6), R.dtype)
    z3 = jnp.zeros((O, 3), R.dtype)
    r = jax.vmap(obs_res)(z6, z3, z3, Ri, ti, Xj, uv_pix)
    Jc = jax.vmap(jax.jacfwd(obs_res, argnums=0))(z6, z3, z3, Ri, ti, Xj, uv_pix)
    Jp = jax.vmap(jax.jacfwd(obs_res, argnums=1))(z6, z3, z3, Ri, ti, Xj, uv_pix)
    Jt = jax.vmap(jax.jacfwd(obs_res, argnums=2))(z6, z3, z3, Ri, ti, Xj, uv_pix)
    m = mask[:, None]
    return (
        jnp.where(m, r, 0.0),
        Jc * m[..., None],
        Jp * m[..., None],
        Jt * m[..., None],
    )


@functools.partial(
    jax.jit,
    static_argnames=("iters", "huber_px", "estimate_f", "estimate_k"),
)
@f32_matmul
def run_ba_joint(
    R, t, X,
    cam_idx, pt_idx, mask, fixed,
    uv_pix,
    intr: Intrinsics,
    *,
    iters: int = 20,
    huber_px: float = 2.0,
    init_lam: float = 1e-3,
    estimate_f: bool = True,
    estimate_k: bool = True,
):
    """JOINT LM bundle adjustment over poses, points, and shared
    intrinsics (f, k1, k2) — pixel-space residuals.

    Accelerator shape: the point blocks are Schur-eliminated exactly as in
    models.bundle_adjust; the reduced camera system gains a 3-column
    GLOBAL BORDER for theta=(f/f0, k1, k2) (f scaled by its initial
    value so the three columns are comparably conditioned), giving one
    dense [6M+3, 6M+3] solve per LM iteration.  Joint — not
    block-coordinate — because a pinhole-collapsed reconstruction of
    distorted data is a joint local minimum where alternating
    (structure | intrinsics) steps are each individually stationary
    (r2 measurement on the dino sequence).

    Returns ((R, t, X), Intrinsics, costs [iters+1]).
    """
    M = R.shape[0]
    P = X.shape[0]
    dt = R.dtype
    f0 = intr.f
    free = (~fixed).astype(dt)
    # theta freedom mask (static): columns we refuse to move.
    tfree = jnp.asarray(
        [1.0 if estimate_f else 0.0,
         1.0 if estimate_k else 0.0,
         1.0 if estimate_k else 0.0], dt)

    def cost_of(R, t, X, th):
        intr_c = Intrinsics(f=th[0] * f0, cx=intr.cx, cy=intr.cy,
                            k1=th[1], k2=th[2])
        r, *_ = _obs_jacobians_intr(
            R, t, X, cam_idx, pt_idx, mask, uv_pix, intr_c
        )
        rn2 = jnp.sum(r * r, -1)
        rn = jnp.sqrt(jnp.maximum(rn2, 1e-24))
        c = jnp.where(rn <= huber_px, 0.5 * rn2,
                      huber_px * (rn - 0.5 * huber_px))
        return jnp.sum(jnp.where(mask, c, 0.0))

    def step(carry, _):
        R, t, X, th, lam, cost = carry
        intr_c = Intrinsics(f=th[0] * f0, cx=intr.cx, cy=intr.cy,
                            k1=th[1], k2=th[2])
        r, Jc, Jp, Jt = _obs_jacobians_intr(
            R, t, X, cam_idx, pt_idx, mask, uv_pix, intr_c
        )
        # theta column scaling: d(resid)/d(theta0) = f0 * d/d f.
        Jt = Jt * jnp.array([f0, 1.0, 1.0], dt)[None, None, :] * tfree
        w = ba._huber_w(jnp.sum(r * r, -1), huber_px) * mask
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]
        Jt_w = Jt * w[:, None, None]
        U = jnp.zeros((M, 6, 6), dt).at[cam_idx].add(
            jnp.einsum("oai,oaj->oij", Jc_w, Jc))
        V = jnp.zeros((P, 3, 3), dt).at[pt_idx].add(
            jnp.einsum("oai,oaj->oij", Jp_w, Jp))
        gc = jnp.zeros((M, 6), dt).at[cam_idx].add(
            jnp.einsum("oai,oa->oi", Jc_w, r))
        gp = jnp.zeros((P, 3), dt).at[pt_idx].add(
            jnp.einsum("oai,oa->oi", Jp_w, r))
        W_obs = jnp.einsum("oai,oaj->oij", Jc_w, Jp)       # [O,6,3]
        Wg = jnp.zeros((P, M, 6, 3), dt).at[pt_idx, cam_idx].add(W_obs)
        Bp = jnp.zeros((P, 3, 3), dt).at[pt_idx].add(
            jnp.einsum("oai,oaj->oij", Jp_w, Jt))          # point-theta
        Bc = jnp.zeros((M, 6, 3), dt).at[cam_idx].add(
            jnp.einsum("oai,oaj->oij", Jc_w, Jt))          # cam-theta
        Ht = jnp.einsum("oai,oaj->ij", Jt_w, Jt)           # [3,3]
        gt = jnp.einsum("oai,oa->i", Jt_w, r)

        dU, dV = ba._damped(U, V, lam)
        dHt = Ht + lam * jnp.eye(3, dtype=dt) * (
            jnp.trace(Ht) / 3.0 + 1e-6)
        Vinv = ba._inv3x3(dV)
        Bv = jnp.einsum("pmix,pxy->pmiy", Wg, Vinv)        # [P,M,6,3]
        S_cc = -jnp.einsum("pmiy,pnjy->minj", Bv, Wg)
        S_cc = S_cc.at[jnp.arange(M), :, jnp.arange(M), :].add(dU)
        S_ct = Bc - jnp.einsum("pmiy,pyk->mik", Bv, Bp)    # [M,6,3]
        S_tt = dHt - jnp.einsum("pxi,pxy,pyj->ij", Bp, Vinv, Bp)
        rhs_c = gc - jnp.einsum("pmiy,py->mi", Bv, gp)
        rhs_t = gt - jnp.einsum("pxi,pxy,py->i", Bp, Vinv, gp)

        # Gauge/freedom masking.
        S_cc = S_cc * free[:, None, None, None] * free[None, None, :, None]
        S_cc = S_cc.at[jnp.arange(M), :, jnp.arange(M), :].add(
            jnp.eye(6, dtype=dt)[None] * fixed[:, None, None].astype(dt))
        S_ct = S_ct * free[:, None, None] * tfree[None, None, :]
        S_tt = S_tt * tfree[:, None] * tfree[None, :] + jnp.diag(1.0 - tfree)
        rhs_c = rhs_c * free[:, None]
        rhs_t = rhs_t * tfree

        n = 6 * M + 3
        S = jnp.zeros((n, n), dt)
        S = S.at[: 6 * M, : 6 * M].set(S_cc.reshape(6 * M, 6 * M))
        S = S.at[: 6 * M, 6 * M :].set(S_ct.reshape(6 * M, 3))
        S = S.at[6 * M :, : 6 * M].set(S_ct.reshape(6 * M, 3).T)
        S = S.at[6 * M :, 6 * M :].set(S_tt)
        rhs = jnp.concatenate([rhs_c.reshape(-1), rhs_t])
        delta = -jnp.linalg.solve(S, rhs)
        dc = delta[: 6 * M].reshape(M, 6) * free[:, None]
        dth = delta[6 * M :] * tfree
        # Back-substitute points: dp = -Vinv (gp + W^T dc + Bp dth).
        Wtdc = jnp.einsum("pmiy,mi->py", Wg, dc)
        dp = -jnp.einsum("pxy,py->px", Vinv, gp + Wtdc
                         + jnp.einsum("pyk,k->py", Bp, dth))

        from sfm_jax.geometry import lie
        Rn = jnp.einsum("mij,mjk->mik", R, lie.so3_exp(dc[:, :3]))
        tn = t + dc[:, 3:]
        Xn = X + dp
        thn = th + dth
        c_new = cost_of(Rn, tn, Xn, thn)
        ok = c_new < cost
        okf = ok.astype(dt)
        R = jnp.where(ok, Rn, R)
        t = jnp.where(ok, tn, t)
        X = jnp.where(ok, Xn, X)
        th = jnp.where(ok, thn, th)
        cost = jnp.where(ok, c_new, cost)
        lam = jnp.clip(jnp.where(ok, lam * 0.33, lam * 8.0), 1e-9, 1e6)
        del okf
        return (R, t, X, th, lam, cost), cost

    th0 = jnp.asarray([1.0, intr.k1, intr.k2], dt)
    c0 = cost_of(R, t, X, th0)
    carry = (R, t, X, th0, jnp.asarray(init_lam, dt), c0)
    (R, t, X, th, _, _), costs = jax.lax.scan(step, carry, None, length=iters)
    out_intr = Intrinsics(f=th[0] * f0, cx=intr.cx, cy=intr.cy,
                          k1=th[1], k2=th[2])
    return (R, t, X), out_intr, jnp.concatenate([c0[None], costs])


def run_ba_selfcal(
    R, t, X,
    cam_idx, pt_idx, mask, fixed,
    uv_pix,
    K,
    *,
    rounds: int = 3,
    ba_iters: int = 15,
    huber_delta: float = 3e-3,
    estimate_k2: bool = True,
):
    """Alternating self-calibrating BA.

    Args mirror BAProblem but observations are PIXELS (uv_pix [O, 2]);
    K is the initial guess (f, principal point).  Returns
    (BAState, Intrinsics, costs [rounds, iters+1]).
    """
    intr = intrinsics_from_K(jnp.asarray(K, jnp.float32))
    R, t, X = jnp.asarray(R), jnp.asarray(t), jnp.asarray(X)
    costs = []
    for rnd in range(rounds):
        uv_n = undistort_normalize(uv_pix, intr)
        problem = ba.BAProblem(
            cam_idx=cam_idx, pt_idx=pt_idx, uv=uv_n, mask=mask, fixed=fixed
        )
        state, cost_hist = ba.run_ba(
            R, t, X, problem, iters=ba_iters, huber_delta=huber_delta
        )
        R, t, X = state.R, state.t, state.X
        costs.append(cost_hist)
        if rnd + 1 < rounds:
            intr = fit_intrinsics(
                R, t, X, cam_idx, pt_idx, mask, uv_pix, intr
            )
            if not estimate_k2:
                intr = intr._replace(k2=jnp.zeros_like(intr.k2))
    return state, intr, jnp.stack(costs)
