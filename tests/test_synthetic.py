"""The seeded synthetic scene (sfm_jax.io.synthetic): determinism,
geometric consistency of the renderer, and a small two-view run that
recovers the known rotation."""

import math

import numpy as np
import jax
import jax.numpy as jnp

from sfm_jax.config import PipelineConfig, RansacConfig, SiftConfig
from sfm_jax.io import synthetic as syn
from sfm_jax.io.image_io import load_gray
from sfm_jax.models import two_view
from sfm_jax.utils import metrics

W, H = 240, 192
F = syn.FOCAL * W / syn.WIDTH     # same field of view as the 720x576 pair


def test_render_deterministic_per_seed():
    K = syn.intrinsics(W, H, F)
    R, t = syn.two_view_poses()[0]
    a = syn.render(syn.make_scene(3), K, R, t, W, H)
    b = syn.render(syn.make_scene(3), K, R, t, W, H)
    c = syn.render(syn.make_scene(4), K, R, t, W, H)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).mean() > 5.0
    assert a.shape == (H, W) and a.dtype == np.float32
    assert 0.0 <= a.min() and a.max() <= 255.0


def test_projected_points_land_on_the_same_texel(rng):
    # A visible scene point, projected into both views, hits the same
    # plane at the same texture coordinates in each.
    scene = syn.make_scene(0)
    K = syn.intrinsics(W, H, F)
    poses = syn.two_view_poses()
    X = syn.scene_points(scene, 400, seed=1)
    hits = []
    for R, t in poses:
        Xc = X @ R.T + t
        u = K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]
        pid, U, V, depth = syn.cast(scene, K, R, t, u, v)
        hits.append((pid, U, V, np.abs(depth - Xc[:, 2]) < 1e-6))
    (p1, u1, v1, vis1), (p2, u2, v2, vis2) = hits
    both = vis1 & vis2          # not occluded in either view
    assert both.sum() > 100
    assert (p1[both] == p2[both]).all()
    cell = syn.CELLS[0]
    assert np.abs(u1[both] - u2[both]).max() < 1e-3 * cell
    assert np.abs(v1[both] - v2[both]).max() < 1e-3 * cell


def test_ppm_roundtrip(tmp_path):
    img = np.linspace(0, 255, W * H, dtype=np.float32).reshape(H, W)
    path = syn.write_ppm(tmp_path / "a.ppm", img)
    np.testing.assert_allclose(load_gray(path), np.rint(img), atol=1e-3)


def test_relative_pose_and_rpe_frame_invariance():
    poses = syn.orbit_poses(4)
    R_gt = np.stack([p[0] for p in poses])
    t_gt = np.stack([p[1] for p in poses])
    # Same trajectory in another world frame and scale: camera i's
    # pose becomes (R_i Q^T, s t_i) for world X' = s Q X.
    Q = syn.look_at([1.0, -0.5, 2.0], target=(0.3, 0.2, 0.1))[0]
    R_e = np.einsum("mij,kj->mik", R_gt, Q)
    t_e = 2.5 * t_gt
    ate, _ = metrics.ate_rmse(R_e, t_e, R_gt, t_gt)
    rpe_r, rpe_t = metrics.rpe_rmse(R_e, t_e, R_gt, t_gt)
    assert ate < 1e-9 and rpe_r < 1e-4 and rpe_t < 1e-4
    R, t = syn.relative_pose(poses[0], poses[1])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.norm(t) - 1.0) < 1e-12


def test_small_two_view_recovers_rotation():
    scene = syn.make_scene(0)
    K = syn.intrinsics(W * 2, H * 2, F * 2)
    poses = syn.two_view_poses()
    img1, img2 = (jnp.asarray(syn.render(scene, K, R, t, W * 2, H * 2))
                  for R, t in poses)
    cfg = PipelineConfig(
        sift=SiftConfig(num_octaves=4, max_pts_per_octave=512),
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128),
        tvote_rounds=0,
    )
    res = two_view.two_view_pipeline(img1, img2, jnp.asarray(K),
                                     jax.random.PRNGKey(0), cfg)
    R_gt, t_gt = syn.relative_pose(*poses)
    R = np.asarray(res.R)
    r_err = math.degrees(math.acos(
        np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    t_err = math.degrees(math.acos(
        np.clip(np.asarray(res.t) @ t_gt / np.linalg.norm(res.t), -1, 1)))
    assert int(res.num_inliers) > 300, int(res.num_inliers)
    assert r_err < 0.5, r_err
    assert t_err < 3.0, t_err
