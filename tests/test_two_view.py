"""End-to-end two-view pipeline test on the reference's canonical
fixture: the dino pair with K = [2360, 0, w/2; 0, 2360, h/2; 0, 0, 1]
(reference src/main.cpp:251-252, 292-297).  The reference's own e2e
test was a visual check of the GL window (README.md:41-52); here we
assert quantitative reconstruction quality."""

import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_jax.config import SiftConfig, PipelineConfig, RansacConfig
from sfm_jax.io.image_io import load_gray
from sfm_jax.models import two_view

DINO = pathlib.Path("/root/reference/data/dino")


@pytest.mark.skipif(not DINO.exists(), reason="dino dataset not available")
@pytest.mark.slow
def test_dino_pair_reconstruction(tmp_path):
    img1 = jnp.asarray(load_gray(DINO / "viff.000.ppm"))
    img2 = jnp.asarray(load_gray(DINO / "viff.001.ppm"))
    h, w = img1.shape
    K = jnp.asarray(
        np.array([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]], np.float32)
    )
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1024, threshold=3e-6, chunk=256),
    )
    res = two_view.run_two_view(img1, img2, K, cfg)
    n_matches = int(res.num_matches)
    n_inliers = int(res.num_inliers)
    n_valid = int(res.point_valid.sum())
    assert n_matches > 500, n_matches
    assert n_inliers > 300, n_inliers
    assert n_valid > 200, n_valid
    # Mean reprojection error in pixels (baseline target: sub-pixel).
    err_px = math.sqrt(float(res.reproj_err) / 2) * 2360.0
    assert err_px < 2.0, err_px
    # Rotation should be small (consecutive turntable frames) and proper.
    R = np.array(res.R)
    assert abs(np.linalg.det(R) - 1) < 1e-4
    angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert angle < 15.0, angle

    # PLY export runs.
    from sfm_jax.io.image_io import save_ply

    out = tmp_path / "dino.ply"
    save_ply(out, np.array(res.points), valid=np.array(res.point_valid))
    assert out.exists() and out.stat().st_size > 1000


@pytest.mark.skipif(not DINO.exists(), reason="dino dataset not available")
@pytest.mark.slow
def test_dino_pair_deterministic():
    img1 = jnp.asarray(load_gray(DINO / "viff.000.ppm"))
    img2 = jnp.asarray(load_gray(DINO / "viff.001.ppm"))
    h, w = img1.shape
    K = jnp.asarray(
        np.array([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]], np.float32)
    )
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=512),
        ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=256),
    )
    r1 = two_view.run_two_view(img1, img2, K, cfg, seed=3)
    r2 = two_view.run_two_view(img1, img2, K, cfg, seed=3)
    np.testing.assert_array_equal(np.array(r1.R), np.array(r2.R))
    np.testing.assert_array_equal(np.array(r1.points), np.array(r2.points))


