"""Tests for the debug/parity dump harness (utils.debug).

The dump is the equivalent of the reference's `enable_debug`
printers (reference SfM/kernels.h:19, SfM/sfm.cu:86-341): it must
expose every printed intermediate and agree with the production
pipeline bit-for-bit where they share computations.
"""

import io

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sfm_jax.config import SiftConfig, PipelineConfig, RansacConfig
from sfm_jax.io.image_io import load_gray
from sfm_jax.models import two_view
from sfm_jax.utils import debug


def _small_cfg():
    return PipelineConfig(
        sift=SiftConfig(num_octaves=3, max_pts_per_octave=256),
        ransac=RansacConfig(n_hyps=256, threshold=3e-6, chunk=128),
    )


@pytest.mark.slow
def test_two_view_dump_matches_pipeline():
    img1 = jnp.asarray(
        load_gray("/root/reference/data/dino/viff.000.ppm")[40:360, 100:612]
    )
    img2 = jnp.asarray(
        load_gray("/root/reference/data/dino/viff.001.ppm")[40:360, 100:612]
    )
    K = jnp.asarray(
        np.array([[2360.0, 0, 256.0], [0, 2360.0, 160.0], [0, 0, 1]], np.float32)
    )
    cfg = _small_cfg()
    key = jax.random.PRNGKey(3)
    d = debug.two_view_dump(img1, img2, K, key, cfg)
    full = two_view.two_view_pipeline(img1, img2, K, key, cfg)

    # The dump's parity surface must agree with the production run.
    assert d["num_matches"] == int(full.num_matches)
    assert d["num_inliers"] == int(full.num_inliers)
    np.testing.assert_array_equal(d["R"], np.asarray(full.R))
    np.testing.assert_array_equal(d["t"], np.asarray(full.t))
    # Reference print surface is present with the right shapes.
    R_hyps = cfg.ransac.n_hyps
    assert d["E_bank"].shape == (R_hyps, 3, 3)
    assert d["inlier_counts"].shape == (R_hyps,)
    assert d["minimal_idx"].shape == (R_hyps, 8)
    assert d["A"].shape == (R_hyps, 8, 9)
    assert d["R_candidates"].shape == (4, 3, 3)
    assert d["t_candidates"].shape == (4, 3)
    assert d["cheirality_votes"].shape == (4,)
    assert d["P_chosen"].shape == (3, 4)
    # The dumped bank must be the SAME bank RANSAC scored: the best
    # hypothesis index points at the returned E (up to LO refit).
    assert 0 <= int(d["best_index"]) < R_hyps
    assert int(d["inlier_counts"][d["best_index"]]) == d["inlier_counts"].max()
    # Minimal sets have no duplicate indices (Floyd sampling contract).
    for row in d["minimal_idx"][:32]:
        assert len(set(row.tolist())) == 8


def test_print_dump_runs():
    # Formatted printer must handle a real dump without error.
    from sfm_jax.io import synthetic as syn

    R, t = syn.two_view_poses()[0]
    img = jnp.asarray(
        syn.render(syn.make_scene(0), syn.intrinsics(), R, t)[200:360, 260:452]
    )
    K = jnp.asarray(
        np.array([[2360.0, 0, 96.0], [0, 2360.0, 80.0], [0, 0, 1]], np.float32)
    )
    cfg = _small_cfg()
    d = debug.two_view_dump(img, img, K, jax.random.PRNGKey(0), cfg)
    buf = io.StringIO()
    debug.print_dump(d, file=buf)
    out = buf.getvalue()
    assert "E_bank_head" in out and "cheirality_votes" in out
    assert "num_inliers" in out
