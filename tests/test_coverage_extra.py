"""Coverage for less-traveled paths: 2x-upscale SIFT, candidate
alignment, larger distributed BA, inverse-iteration eigensolver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers import rot, synthetic_two_view
from sfm_jax.config import SiftConfig
from sfm_jax.sift import frontend
from sfm_jax.geometry import pose
from sfm_jax.ops import linalg


def test_upscale_extraction(rng):
    # 2x upscale path (reference scaleUp + RescalePositions,
    # cudaSiftH.cu:119-133): coordinates must come back in input pixels.
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    img = np.zeros((64, 64), np.float32)
    for cy, cx, s in [(20.3, 40.2, 2.0), (44.6, 18.4, 3.0)]:
        img += 200.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=64, up_scale=True)
    res = frontend.extract_sift(jnp.asarray(img), cfg)
    kp = res.keypoints
    v = np.array(kp.valid)
    assert v.sum() >= 2
    xs, ys = np.array(kp.x)[v], np.array(kp.y)[v]
    assert xs.max() < 64 and ys.max() < 64  # rescaled to input pixels
    for cy, cx, s in [(20.3, 40.2, 2.0), (44.6, 18.4, 3.0)]:
        d = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        assert d.min() < 1.0


def test_align_candidates_picks_reference_branch(rng):
    s = synthetic_two_view(np.random.default_rng(3), n_points=64, noise=0.0)
    E = jnp.asarray(s["E"])
    R_ref = jnp.asarray(s["R"])
    t_ref = jnp.asarray(s["t"])
    R, t = pose.align_candidates(E, R_ref, t_ref)
    assert np.abs(np.array(R) - s["R"]).max() < 1e-3
    assert np.linalg.norm(np.array(t) - s["t"]) < 1e-3
    # And with the flipped reference it picks the opposite translation.
    R2, t2 = pose.align_candidates(E, R_ref, -t_ref)
    assert np.linalg.norm(np.array(t2) + s["t"]) < 1e-3


def test_inverse_iteration_eigsolver(rng):
    Q, _ = np.linalg.qr(rng.normal(size=(9, 9)))
    w = np.sort(rng.uniform(10, 500, 9))
    w[0] = 1e-4
    G = (Q * w) @ Q.T
    v = np.array(linalg.smallest_eigvec_power(jnp.asarray(G.astype(np.float32))))
    assert abs(v @ Q[:, 0]) > 0.9999


def test_dist_ba_larger_problem(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sfm_jax.parallel import mesh as meshmod, dist_ba
    from sfm_jax.models import bundle_adjust as ba

    mesh = meshmod.make_mesh(8)
    M, P = 12, 1200
    X_gt = rng.uniform([-2, -2, 4], [2, 2, 10], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for k in range(M):
        Rk = rot([0, 1, 0], 0.05 * k)
        pos = np.array([0.3 * k, 0.02 * k, 0])
        Rs.append(Rk)
        ts.append(-Rk @ pos)
    R_gt = np.stack(Rs).astype(np.float32)
    t_gt = np.stack(ts).astype(np.float32)
    # Each camera sees a random 60% subset of points.
    cam_idx, pt_idx = [], []
    for k in range(M):
        sel = rng.choice(P, int(0.6 * P), replace=False)
        cam_idx.append(np.full(sel.shape, k))
        pt_idx.append(sel)
    cam_idx = np.concatenate(cam_idx).astype(np.int32)
    pt_idx = np.concatenate(pt_idx).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X_gt[pt_idx]) + t_gt[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:3] + rng.normal(scale=4e-4, size=(len(cam_idx), 2))).astype(np.float32)
    mask = np.ones(len(cam_idx), bool)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    prob = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
        jnp.asarray(mask), jnp.asarray(fixed),
    )
    R0 = np.stack(
        [R_gt[k] @ rot(rng.normal(size=3), 0.02 if k else 0) for k in range(M)]
    ).astype(np.float32)
    t0 = (t_gt + np.where(np.arange(M)[:, None] > 0,
                          rng.normal(scale=0.02, size=t_gt.shape), 0)).astype(np.float32)
    X0 = (X_gt + rng.normal(scale=0.02, size=X_gt.shape)).astype(np.float32)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 8)
    R_d, t_d, X_d, costs = dist_ba.run_dist_ba(
        jnp.asarray(R0), jnp.asarray(t0), X_sh, prob_sh, mesh, iters=12
    )
    costs = np.array(costs)
    assert costs[-1] < 0.05 * costs[0]
    from sfm_jax.utils import metrics

    rmse, _ = metrics.ate_rmse(np.array(R_d), np.array(t_d), R_gt, t_gt)
    assert rmse < 5e-3, rmse
