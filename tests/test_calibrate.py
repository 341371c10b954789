"""Tests for self-calibrating BA (shared focal + radial distortion).

No reference counterpart (the reference hard-codes K,
/root/reference/src/main.cpp:292-297); these tests pin the behavior
that motivated the module: unmodeled k1 distortion on a narrow-FOV
turntable collapses recovered rotation, and the joint
intrinsics-bordered BA must recover (f, k1) from distorted pixels.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from helpers import rot
from sfm_jax.models import calibrate as cal


F_GT = 2800.0
CX, CY = 360.0, 288.0
K1_GT = -0.28


def _turntable(rng, M=6, P=160, step_deg=10.0, radius=6.0, k1=K1_GT,
               noise_px=0.15):
    """M cameras orbiting a point cloud; pixel obs with k1 distortion."""
    X = rng.uniform([-1, -1, -1], [1, 1, 1], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for i in range(M):
        th = math.radians(step_deg) * i
        Ri = rot([0, 1, 0], th)
        c = Ri.T @ np.array([0.0, 0.0, -radius])  # orbit the origin
        Rs.append(Ri)
        ts.append(-Ri @ c)
    R = np.stack(Rs).astype(np.float32)
    t = np.stack(ts).astype(np.float32)
    cam_idx = np.repeat(np.arange(M), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), M).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
    xn = Xc[:, :2] / Xc[:, 2:3]
    r2 = (xn ** 2).sum(1, keepdims=True)
    uv = (CX, CY) + F_GT * xn * (1.0 + k1 * r2)
    uv = (uv + rng.normal(scale=noise_px, size=uv.shape)).astype(np.float32)
    mask = np.ones(len(uv), bool)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    return (
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(mask),
        jnp.asarray(fixed), jnp.asarray(uv),
    )


def test_undistort_inverts_distort(rng):
    intr = cal.Intrinsics(
        f=jnp.asarray(F_GT), cx=jnp.asarray(CX), cy=jnp.asarray(CY),
        k1=jnp.asarray(K1_GT), k2=jnp.asarray(0.03),
    )
    xn = jnp.asarray(rng.uniform(-0.12, 0.12, size=(200, 2)).astype(np.float32))
    uv = cal.project_pixels(xn, intr)
    back = cal.undistort_normalize(uv, intr, iters=8)
    assert float(jnp.abs(back - xn).max()) < 2e-5


def test_fit_intrinsics_recovers_f_k1(rng):
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng)
    intr0 = cal.Intrinsics(
        f=jnp.asarray(0.8 * F_GT), cx=jnp.asarray(CX), cy=jnp.asarray(CY),
        k1=jnp.asarray(0.0), k2=jnp.asarray(0.0),
    )
    # Structure fixed at GT: the closed-form fit is a plain linear LS.
    fit = cal.fit_intrinsics(R, t, X, ci, pi, mask, uv, intr0)
    assert abs(float(fit.f) - F_GT) / F_GT < 0.01, float(fit.f)
    assert abs(float(fit.k1) - K1_GT) < 0.03, float(fit.k1)


@pytest.mark.slow
def test_joint_ba_recovers_intrinsics_from_perturbed_init(rng):
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng)
    # Perturb poses/points; start from a 12%-wrong focal, zero k.
    Rn = np.array(R)
    tn = np.array(t) + np.where(
        np.arange(len(t))[:, None] > 0,
        rng.normal(scale=0.02, size=t.shape), 0).astype(np.float32)
    for i in range(1, len(Rn)):
        Rn[i] = Rn[i] @ rot(rng.normal(size=3), 0.015)
    Xn = np.array(X) + rng.normal(scale=0.02, size=X.shape).astype(np.float32)
    intr0 = cal.Intrinsics(
        f=jnp.asarray(0.88 * F_GT), cx=jnp.asarray(CX), cy=jnp.asarray(CY),
        k1=jnp.asarray(0.0), k2=jnp.asarray(0.0),
    )
    (R2, t2, X2), intr, costs = cal.run_ba_joint(
        jnp.asarray(Rn), jnp.asarray(tn), jnp.asarray(Xn),
        ci, pi, mask, fixed, uv, intr0, iters=25, huber_px=2.0,
    )
    costs = np.array(costs)
    assert costs[-1] < costs[0] * 0.05
    assert abs(float(intr.f) - F_GT) / F_GT < 0.02, float(intr.f)
    assert abs(float(intr.k1) - K1_GT) < 0.05, float(intr.k1)
    # Residual RMS at the solution ~ the injected pixel noise.
    r, *_ = cal._obs_jacobians_intr(R2, t2, X2, ci, pi, mask, uv, intr)
    rms = float(jnp.sqrt((r ** 2).sum(1).mean()))
    assert rms < 0.6, rms


def test_joint_ba_pinhole_mode_matches_plain_ba(rng):
    # estimate_f=False, estimate_k=False must leave intrinsics fixed.
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng, k1=0.0)
    intr0 = cal.Intrinsics(
        f=jnp.asarray(F_GT), cx=jnp.asarray(CX), cy=jnp.asarray(CY),
        k1=jnp.asarray(0.0), k2=jnp.asarray(0.0),
    )
    (R2, t2, X2), intr, costs = cal.run_ba_joint(
        R, t, X, ci, pi, mask, fixed, uv, intr0,
        iters=8, estimate_f=False, estimate_k=False,
    )
    assert float(intr.f) == pytest.approx(F_GT)
    assert float(intr.k1) == 0.0 and float(intr.k2) == 0.0
