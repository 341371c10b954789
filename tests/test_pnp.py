"""Tests for DLT PnP + RANSAC + GN refinement."""

import numpy as np
import jax
import jax.numpy as jnp

from helpers import rot, rot_angle_error
from sfm_jax.geometry import pnp


def _scene(rng, n=100, noise=0.0, outliers=0):
    R = rot([0.2, 1.0, 0.1], 0.4).astype(np.float32)
    t = np.array([0.3, -0.2, 0.5], np.float32)
    X = rng.uniform([-1, -1, 3], [1, 1, 7], size=(n, 3)).astype(np.float32)
    Xc = X @ R.T + t
    x = Xc / Xc[:, 2:3]
    if noise:
        x = x.copy()
        x[:, :2] += rng.normal(scale=noise, size=(n, 2))
    if outliers:
        x[:outliers, :2] = rng.uniform(-0.4, 0.4, size=(outliers, 2))
    return x.astype(np.float32), X, R, t


def test_pnp_dlt_exact(rng):
    x, X, R, t = _scene(rng, n=24)
    # Conditioned frame: center/scale points like ransac_pnp does.
    c = X.mean(0)
    s = np.linalg.norm(X - c, axis=1).mean()
    Xn = (X - c) / s
    R_est, t_est = pnp.pnp_dlt(jnp.asarray(x), jnp.asarray(Xn))
    assert rot_angle_error(np.array(R_est), R) < 1e-3
    t_world = s * np.array(t_est) - np.array(R_est) @ c
    assert np.linalg.norm(t_world - t) < 5e-3


def test_ransac_pnp_with_outliers(rng):
    x, X, R, t = _scene(rng, n=200, noise=3e-4, outliers=60)
    res = pnp.ransac_pnp(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(X),
        n_hyps=512, threshold=1e-5,
    )
    assert int(res.num_inliers) > 120
    inl = np.array(res.inliers)
    assert inl[:60].sum() <= 3  # outliers rejected
    assert rot_angle_error(np.array(res.R), R) < 5e-3
    assert np.linalg.norm(np.array(res.t) - t) < 0.05


def test_ransac_pnp_mask(rng):
    x, X, R, t = _scene(rng, n=150, noise=3e-4)
    # Corrupt unmasked region heavily
    mask = np.ones(150, bool)
    mask[:50] = False
    x2 = x.copy()
    x2[:50] = rng.uniform(-0.5, 0.5, size=(50, 3)).astype(np.float32)
    x2[:50, 2] = 1.0
    res = pnp.ransac_pnp(
        jax.random.PRNGKey(1), jnp.asarray(x2), jnp.asarray(X),
        jnp.asarray(mask), n_hyps=256, threshold=1e-5,
    )
    assert rot_angle_error(np.array(res.R), R) < 5e-3
    assert not np.array(res.inliers)[:50].any()


def test_refine_pose_improves(rng):
    x, X, R, t = _scene(rng, n=100, noise=5e-4)
    R0 = (R @ rot(rng.normal(size=3), 0.05)).astype(np.float32)
    t0 = (t + rng.normal(scale=0.05, size=3)).astype(np.float32)
    Rf, tf = pnp.refine_pose(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(x), jnp.asarray(X), iters=10
    )
    assert rot_angle_error(np.array(Rf), R) < rot_angle_error(R0, R) * 0.2
    assert np.linalg.norm(np.array(tf) - t) < 0.01
