"""Tests for Schur-complement LM bundle adjustment."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers import rot
from sfm_jax.models import bundle_adjust as ba


def _make_problem(rng, M=5, P=200, noise=5e-4, perturb=0.03, outliers=0):
    X_gt = rng.uniform([-1, -1, 4], [1, 1, 7], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for i in range(M):
        Ri = rot([0, 1, 0], 0.08 * i) @ rot([1, 0, 0], 0.02 * i)
        pos = np.array([0.4 * i, 0.05 * i, 0.0])
        Rs.append(Ri)
        ts.append(-Ri @ pos)
    R_gt = np.stack(Rs).astype(np.float32)
    t_gt = np.stack(ts).astype(np.float32)
    cam_idx = np.repeat(np.arange(M), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), M).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X_gt[pt_idx]) + t_gt[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    uv += rng.normal(scale=noise, size=uv.shape).astype(np.float32)
    if outliers:
        uv[:outliers] += rng.uniform(0.05, 0.2, size=(outliers, 2)).astype(np.float32)
    mask = np.ones(len(uv), bool)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    R0 = np.stack(
        [R_gt[i] @ rot(rng.normal(size=3), perturb if i else 0.0) for i in range(M)]
    ).astype(np.float32)
    t0 = (
        t_gt
        + np.where(np.arange(M)[:, None] > 0, rng.normal(scale=perturb, size=t_gt.shape), 0)
    ).astype(np.float32)
    X0 = (X_gt + rng.normal(scale=perturb, size=X_gt.shape)).astype(np.float32)
    prob = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
        jnp.asarray(mask), jnp.asarray(fixed),
    )
    return prob, (R_gt, t_gt, X_gt), (R0, t0, X0), noise


def test_ba_converges_to_noise_floor(rng):
    prob, gt, init, noise = _make_problem(rng)
    final, costs = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=25,
    )
    costs = np.array(costs)
    assert costs[-1] < costs[0] * 0.05
    r = np.array(ba._residuals(final.R, final.t, final.X, prob))
    rms = np.sqrt((r ** 2).sum(1).mean())
    assert rms < 3 * noise


def test_ba_monotone_cost(rng):
    prob, gt, init, _ = _make_problem(rng, perturb=0.05)
    _, costs = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=15,
    )
    costs = np.array(costs)
    assert np.all(np.diff(costs) <= 1e-6)  # accept/reject never increases


def test_ba_fixed_camera_unchanged(rng):
    prob, gt, init, _ = _make_problem(rng)
    final, _ = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=10,
    )
    np.testing.assert_array_equal(np.array(final.R[0]), init[0][0])
    np.testing.assert_array_equal(np.array(final.t[0]), init[1][0])


def test_ba_pose_recovery(rng):
    prob, (R_gt, t_gt, X_gt), init, _ = _make_problem(rng, perturb=0.02)
    final, _ = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=25,
    )
    for i in range(1, R_gt.shape[0]):
        dR = np.array(final.R[i]) @ R_gt[i].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 4e-3, (i, ang)


def test_ba_ate_within_bound(rng):
    """North-star metric: absolute trajectory error after BA."""
    from sfm_jax.utils import metrics

    prob, (R_gt, t_gt, X_gt), init, _ = _make_problem(rng, perturb=0.03)
    pre_rmse, _ = metrics.ate_rmse(init[0], init[1], R_gt, t_gt)
    final, _ = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=25,
    )
    post_rmse, _ = metrics.ate_rmse(
        np.array(final.R), np.array(final.t), R_gt, t_gt
    )
    # f32 BA at observation noise 5e-4 rad: ~20x ATE reduction, landing
    # at the noise/gauge floor (~0.1% of the trajectory span).
    assert post_rmse < 0.1 * max(pre_rmse, 1e-9), (pre_rmse, post_rmse)
    assert post_rmse < 3e-3


def test_ba_robust_to_outliers(rng):
    # Huber alone leaves bias under one-sided gross outliers; the
    # production pattern (models.incremental) is BA -> prune by
    # residual -> polish.  Assert that pattern recovers the poses.
    prob, (R_gt, t_gt, X_gt), init, _ = _make_problem(rng, outliers=50)
    final, _ = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob, iters=20, huber_delta=2e-3,
    )
    r = np.array(ba._residuals(final.R, final.t, final.X, prob))
    rn2 = (r ** 2).sum(1)
    med = np.median(rn2[np.array(prob.mask)])
    keep = jnp.asarray(rn2 < 25.0 * med + 1e-12) & prob.mask
    prob2 = prob._replace(mask=keep)
    final, _ = ba.run_ba(final.R, final.t, final.X, prob2, iters=15,
                         huber_delta=2e-3)
    assert int(np.array(keep).sum()) > 800  # inliers survive the prune
    # Bound = the clean-problem noise floor of this scene (the prune
    # removes all 50 outliers; the optimum equals the no-outlier one).
    for i in range(1, R_gt.shape[0]):
        dR = np.array(final.R[i]) @ R_gt[i].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 8e-3, (i, ang)


def test_ba_masked_observations_ignored(rng):
    prob, gt, init, _ = _make_problem(rng)
    # Corrupt half the observations but mask them out.
    uv = np.array(prob.uv)
    n = uv.shape[0]
    mask = np.ones(n, bool)
    mask[: n // 2] = False
    uv[: n // 2] = 1e3
    prob2 = prob._replace(uv=jnp.asarray(uv), mask=jnp.asarray(mask))
    final, costs = ba.run_ba(
        jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]),
        prob2, iters=15,
    )
    assert np.isfinite(np.array(costs)).all()
    r = np.array(ba._residuals(final.R, final.t, final.X, prob2))
    rms = np.sqrt((r ** 2).sum(1)[n // 2 :].mean())
    assert rms < 5e-3


def test_ba_cg_matches_dense():
    # The matrix-free CG Schur solver must land at the same optimum as
    # the exact dense solve on a problem small enough for both.
    rng = np.random.default_rng(3)
    prob, gt, init, noise = _make_problem(rng, M=6, P=150, perturb=0.03)
    args = (jnp.asarray(init[0]), jnp.asarray(init[1]), jnp.asarray(init[2]))
    fd, cd = ba.run_ba(*args, prob, iters=20, solver="dense")
    fc, cc = ba.run_ba(*args, prob, iters=20, solver="cg", cg_iters=40)
    assert float(cc[-1]) < float(cd[0]) * 0.05
    assert float(cc[-1]) < float(cd[-1]) * 1.2 + 1e-9
    for i in range(1, 6):
        dR = np.array(fc.R[i]) @ np.array(fd.R[i]).T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 4e-3, (i, ang)


def test_ba_cg_scales_to_many_cameras():
    # M=50 cameras / 5000 points / 30k observations: the dense path
    # would materialize Wg [5000,50,6,3] (~18 MB) and S [300,300];
    # the CG path touches only O(O) state.  Convergence + pose quality.
    rng = np.random.default_rng(4)
    M, P = 50, 5000
    X_gt = rng.uniform([-2, -2, 4], [2, 2, 10], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for i in range(M):
        Ri = rot([0, 1, 0], 0.02 * i) @ rot([1, 0, 0], 0.005 * i)
        pos = np.array([0.1 * i, 0.02 * i, 0.0])
        Rs.append(Ri)
        ts.append(-Ri @ pos)
    R_gt = np.stack(Rs).astype(np.float32)
    t_gt = np.stack(ts).astype(np.float32)
    # each camera observes a random 600-point subset
    obs_per_cam = 600
    cam_idx = np.repeat(np.arange(M), obs_per_cam).astype(np.int32)
    pt_idx = np.concatenate(
        [rng.choice(P, obs_per_cam, replace=False) for _ in range(M)]
    ).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X_gt[pt_idx]) + t_gt[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    uv += rng.normal(scale=3e-4, size=uv.shape).astype(np.float32)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    prob = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
        jnp.ones(len(uv), bool), jnp.asarray(fixed),
    )
    perturb = 0.02
    R0 = np.stack(
        [R_gt[i] @ rot(rng.normal(size=3), perturb if i else 0.0) for i in range(M)]
    ).astype(np.float32)
    t0 = (t_gt + np.where(np.arange(M)[:, None] > 0,
                          rng.normal(scale=perturb, size=t_gt.shape), 0)
          ).astype(np.float32)
    X0 = (X_gt + rng.normal(scale=perturb, size=X_gt.shape)).astype(np.float32)
    final, costs = ba.run_ba(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0), prob,
        iters=15, solver="cg", cg_iters=30,
    )
    costs = np.array(costs)
    assert costs[-1] < costs[0] * 0.02, costs[[0, -1]]
    for i in range(1, M, 7):
        dR = np.array(final.R[i]) @ R_gt[i].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 3e-3, (i, ang)
