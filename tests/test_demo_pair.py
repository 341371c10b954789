"""Reference SIFT-demo parity: extract + match + homography on the
CudaSift stereo pair.

The reference's own integration test for its feature subsystem is
mainSift.cpp:25-93 (extract on data/left.pgm + data/righ.pgm, brute
match, FindHomography, report match counts) — SURVEY.md §4 item 4.
This runs the same pipeline on the same checked-in 1280x960 pair and
asserts healthy feature / match / homography-inlier counts, i.e. the
frontend generalizes beyond the dino turntable fixture.
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_jax.config import MatchConfig, SiftConfig
from sfm_jax.geometry import homography
from sfm_jax.io.image_io import load_gray
from sfm_jax.sift import frontend, match as match_mod

DATA = pathlib.Path("/root/reference/CudaSift/data")


@pytest.mark.skipif(not DATA.exists(), reason="CudaSift demo pair not available")
@pytest.mark.slow
def test_demo_pair_match_homography():
    img1 = load_gray(DATA / "left.pgm")
    img2 = load_gray(DATA / "righ.pgm")
    assert img1.shape == (960, 1280)

    cfg = SiftConfig(thresh=3.0, max_pts_per_octave=512)
    f1 = frontend.extract_sift(jnp.asarray(img1), cfg)
    f2 = frontend.extract_sift(jnp.asarray(img2), cfg)
    n1 = int(f1.keypoints.count())
    n2 = int(f2.keypoints.count())
    assert n1 > 500 and n2 > 500, (n1, n2)

    m = match_mod.match(
        f1.descriptors, f2.descriptors,
        f1.keypoints.valid, f2.keypoints.valid,
        MatchConfig(),
    )
    uv1 = jnp.stack([f1.keypoints.x, f1.keypoints.y], axis=-1)
    uv2 = jnp.stack([f2.keypoints.x, f2.keypoints.y], axis=-1)[m.index]
    n_match = int(jnp.sum(m.valid))
    assert n_match > 500, n_match

    res = homography.ransac_homography(
        jax.random.PRNGKey(0), uv1, uv2, m.valid, n_hyps=1024, threshold=9.0
    )
    n_inl = int(res.num_inliers)
    # The pair is a wide-baseline stereo of a mostly-planar scene; the
    # reference reports a large matching fraction under its 5 px
    # homography gate (mainSift.cpp:80-81).
    assert n_inl > 0.5 * n_match, (n_inl, n_match)
    err2 = np.asarray(homography.transfer_errors(res.H, uv1, uv2))
    e = err2[np.asarray(res.inliers)]
    assert np.median(e) < 9.0, np.median(e)


@pytest.mark.skipif(not DATA.exists(), reason="CudaSift demo pair not available")
@pytest.mark.slow
def test_demo_pair_up_scale():
    """The 2x up-scale path at the reference's published config class.

    CudaSift's README benchmark table (CudaSift/README.md:126-134)
    reports upScale=True thresh=2.0 -> 4502 matches on this pair (vs
    2720 at upScale=False): up-scaling should FIND MORE features and
    keep the match rate.  This pins the behavioral contract — and
    guards the reduced-precision phantom-detection regression (the DoG
    blurs run at ops.image.BLUR_PRECISION).

    Runs on a 2x-decimated pair (640x480, so the up-scaled base is the
    original 1280x960) to keep the CPU suite fast while preserving the
    full stereo overlap (crops lose match partners across the
    disparity).
    """
    img1 = load_gray(DATA / "left.pgm")[::2, ::2]
    img2 = load_gray(DATA / "righ.pgm")[::2, ::2]

    counts = {}
    for up in (False, True):
        cfg = SiftConfig(
            num_octaves=5, max_pts_per_octave=1024, sample_cap=4096,
            thresh=2.0, up_scale=up,
        )
        f1 = frontend.extract_sift(jnp.asarray(img1), cfg)
        f2 = frontend.extract_sift(jnp.asarray(img2), cfg)
        m = match_mod.match(
            f1.descriptors, f2.descriptors,
            f1.keypoints.valid, f2.keypoints.valid,
            MatchConfig(),
        )
        counts[up] = (
            int(f1.keypoints.count()),
            int(f2.keypoints.count()),
            int(jnp.sum(m.valid)),
        )

    n1_up, n2_up, nm_up = counts[True]
    _, _, nm_noup = counts[False]
    # Up-scaling adds a -1 octave: strictly more features and more
    # matches than the non-upscaled run (reference: 4502 vs 2720).
    assert n1_up > counts[False][0] and n2_up > counts[False][1], counts
    assert nm_up > nm_noup, counts
    # Match-rate sanity: reference reports ~43% matching at this config
    # (4502/10388); phantom detections drove this to 18% on device.
    rate = nm_up / max(n1_up, 1)
    assert rate > 0.30, (rate, counts)
