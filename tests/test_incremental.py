"""Incremental multi-view SfM on the dino sequence (driver config 3),
plus a synthetic-orbit run with ground-truth poses for the north-star
ATE-after-BA metric (the dino set has no GT trajectory; SURVEY.md §6)."""

import math
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from sfm_jax.config import SiftConfig, PipelineConfig, RansacConfig
from sfm_jax.io.image_io import load_gray
from sfm_jax.models import incremental
from sfm_jax.sift.frontend import Keypoints, SiftResult
from sfm_jax.utils import metrics

DINO = pathlib.Path("/root/reference/data/dino")


def _look_at(C, target=np.zeros(3), up=(0.0, 1.0, 0.0)):
    """World->camera rotation with +z toward `target` from center C."""
    z = target - C
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def _synthetic_orbit(
    n_images=8, n_points=220, kp_cap=256, f=500.0, w=640, h=480,
    step_deg=8.0, noise_px=0.3, seed=3, visibility_deg=None,
):
    """Cameras orbiting a random cloud; returns (feats, K, R_gt, t_gt).

    Features are injected via run_incremental(feats=...) — unique
    near-orthogonal unit descriptors per world point, per-frame slot
    shuffles, and pixel noise — exercising matching, PnP registration,
    windowed + global BA on a problem whose trajectory is known.
    """
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n_points, 3))
    desc = rng.normal(size=(n_points, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    feats, R_gt, t_gt = [], [], []
    for i in range(n_images):
        th = math.radians(step_deg * i)
        C = np.array([5.0 * math.sin(th), 0.6, -5.0 * math.cos(th)])
        R, t = _look_at(C)
        R_gt.append(R)
        t_gt.append(t)
        xc = X @ R.T + t
        uv = (xc[:, :2] / xc[:, 2:3]) * f + np.array([w / 2, h / 2])
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        if visibility_deg is not None:
            # Self-occlusion model: a point is visible only from cameras
            # within `visibility_deg` of its azimuth, so tracks cannot
            # chain all the way around the ring — only a loop-closure
            # edge can tie frame 0 to frame n-1.
            pt_az = np.degrees(np.arctan2(X[:, 0], -X[:, 2]))
            cam_az = math.degrees(th)
            d_az = (pt_az - cam_az + 180.0) % 360.0 - 180.0
            vis = np.abs(d_az) < visibility_deg
        else:
            vis = np.ones(n_points, bool)
        slots = rng.permutation(kp_cap)[:n_points]
        x_s = np.zeros(kp_cap, np.float32)
        y_s = np.zeros(kp_cap, np.float32)
        d_s = np.zeros((kp_cap, 128), np.float32)
        v_s = np.zeros(kp_cap, bool)
        x_s[slots] = uv[:, 0]
        y_s[slots] = uv[:, 1]
        nd = desc + rng.normal(scale=0.03, size=desc.shape).astype(np.float32)
        d_s[slots] = nd / np.linalg.norm(nd, axis=1, keepdims=True)
        v_s[slots] = vis
        ones = np.ones(kp_cap, np.float32)
        kp = Keypoints(
            x=jnp.asarray(x_s), y=jnp.asarray(y_s), scale=jnp.asarray(ones),
            sharpness=jnp.asarray(ones), edgeness=jnp.asarray(ones),
            orientation=jnp.zeros(kp_cap), octave=jnp.zeros(kp_cap, jnp.int32),
            valid=jnp.asarray(v_s),
        )
        feats.append(SiftResult(keypoints=kp, descriptors=jnp.asarray(d_s)))
    return feats, K, np.stack(R_gt), np.stack(t_gt)


@pytest.mark.slow
def test_incremental_synthetic_orbit_ate():
    feats, K, R_gt, t_gt = _synthetic_orbit()
    cfg = PipelineConfig(
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128),
    )
    imgs = [None] * len(feats)  # unused when feats= is given
    res = incremental.run_incremental(imgs, K, cfg, ba_iters=12, feats=feats)
    st = res.state
    assert np.array(st.pose_valid).all(), np.array(st.pose_valid)
    ate, _ = metrics.ate_rmse(np.array(st.R), np.array(st.t), R_gt, t_gt)
    # Orbit radius 5.0; sub-1% trajectory error after BA.
    assert ate < 0.05, ate
    err_px = math.sqrt(float(res.mean_reproj) / 2) * 500.0
    assert err_px < 1.0, err_px


@pytest.mark.slow
def test_incremental_windowed_ba_compaction_parity():
    """The window-compacted local BA (per-frame cost O(window))
    must land on the same trajectory as the
    uncompacted O(all-frames) local BA: the compaction keeps every
    observation a window camera can interact with (its own plus the
    fixed-camera anchors of its points)."""
    feats, K, R_gt, t_gt = _synthetic_orbit(n_images=12, seed=7)
    cfg = PipelineConfig(
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128),
    )
    imgs = [None] * len(feats)
    kw = dict(ba_iters=12, feats=feats)
    res_win = incremental.run_incremental(imgs, K, cfg, **kw)  # auto cap
    res_full = incremental.run_incremental(
        imgs, K, cfg, local_ba_obs_cap=0, **kw
    )
    # 12 frames x 256 slots = 3072 > (5+3+2)*256 = 2560, so the auto
    # cap is active in res_win.
    assert np.array(res_win.state.pose_valid).all()
    ate_w, _ = metrics.ate_rmse(
        np.array(res_win.state.R), np.array(res_win.state.t), R_gt, t_gt
    )
    ate_f, _ = metrics.ate_rmse(
        np.array(res_full.state.R), np.array(res_full.state.t), R_gt, t_gt
    )
    assert ate_w < 0.05, ate_w
    assert abs(ate_w - ate_f) < 0.01, (ate_w, ate_f)


@pytest.mark.slow
def test_incremental_loop_closure_tightens_ate():
    """A full synthetic ring with self-occlusion (tracks cannot chain
    around) accumulates drift that only the wrap edge can correct:
    closure_pairs must reduce ATE."""
    feats, K, R_gt, t_gt = _synthetic_orbit(
        n_images=12, step_deg=30.0, n_points=240, noise_px=1.0,
        visibility_deg=75.0, seed=5,
    )
    cfg = PipelineConfig(
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128),
    )
    imgs = [None] * len(feats)
    # local_ba_obs_cap=0 pins the uncompacted local BA this fixture's
    # thresholds were calibrated against (r3: open 0.078, closed
    # 0.053): the window compaction changes f32 summation order, which
    # flips one frame-8 RANSAC draw on this chaos-sensitive synthetic
    # ring (closure still tightens ATE there, at a narrower margin).
    # Compaction itself is covered by
    # test_incremental_windowed_ba_compaction_parity.
    kw = dict(ba_iters=12, feats=feats, local_ba_iters=2,
              local_ba_obs_cap=0)
    res_open = incremental.run_incremental(imgs, K, cfg, **kw)
    res_closed = incremental.run_incremental(
        imgs, K, cfg, closure_pairs=[(11, 0)], **kw
    )
    assert np.array(res_closed.state.pose_valid).all()
    ate_open, _ = metrics.ate_rmse(
        np.array(res_open.state.R), np.array(res_open.state.t), R_gt, t_gt
    )
    ate_closed, _ = metrics.ate_rmse(
        np.array(res_closed.state.R), np.array(res_closed.state.t),
        R_gt, t_gt,
    )
    # Measured: open 0.078, closed 0.053, full-visibility noise floor
    # 0.039 (1 px noise, f=500, radius 5).
    assert ate_closed < 0.8 * ate_open, (ate_closed, ate_open)
    assert ate_closed < 0.06, ate_closed


@pytest.mark.skipif(not DINO.exists(), reason="dino dataset not available")
@pytest.mark.slow
def test_incremental_dino_sequence():
    imgs = [load_gray(DINO / f"viff.00{i}.ppm") for i in range(5)]
    h, w = imgs[0].shape
    K = np.array(
        [[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]], np.float32
    )
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=512),
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128),
    )
    res = incremental.run_incremental(imgs, K, cfg, ba_iters=12)
    st = res.state
    assert np.array(st.pose_valid).all(), np.array(st.pose_valid)
    assert int(st.n_points) > 500
    costs = np.array(res.ba_costs)
    assert costs[-1] < costs[0]  # BA reduced the cost
    assert np.isfinite(costs).all()
    # Turntable: consecutive rotations similar magnitude, same axis sign.
    R = np.array(st.R)
    angles = []
    for i in range(1, len(imgs)):
        dR = R[i] @ R[i - 1].T
        angles.append(
            math.degrees(math.acos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        )
    assert all(1.0 < a < 15.0 for a in angles), angles
    # Reprojection: mean squared (normalized) -> < ~2.5 px at f=2360.
    err_px = math.sqrt(float(res.mean_reproj) / 2) * 2360.0
    assert err_px < 2.5, err_px
