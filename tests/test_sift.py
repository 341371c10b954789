"""Tests for the SIFT frontend: pyramid, detection, orientation,
descriptors, matching.

Verification model follows the reference's only real test harness —
CPU-vs-GPU match checking in CudaSift/match.cu:132-142 — generalized:
every stage is checked against either a definitional numpy
implementation or a known synthetic ground truth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_jax.config import SiftConfig, MatchConfig
from sfm_jax.ops import image as imops
from sfm_jax.sift import pyramid, detect as detect_mod, orient, describe, match as match_mod, frontend


def _np_blur(img, taps):
    """Definitional separable blur with edge clamp (numpy reference)."""
    r = len(taps) // 2
    pad = np.pad(img, r, mode="edge")
    tmp = np.zeros_like(pad)
    for j, t in enumerate(taps):
        tmp[:, r:-r] += t * pad[:, j : j + img.shape[1]]
    out = np.zeros_like(img)
    for j, t in enumerate(taps):
        out += t * tmp[j : j + img.shape[0], r:-r]
    return out


def test_blur_matches_numpy(rng):
    img = rng.normal(size=(33, 47)).astype(np.float32)
    taps = imops.gaussian_kernel(4, 1.3)
    out = np.array(imops.blur(jnp.asarray(img), taps))
    ref = _np_blur(img, taps)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_gaussian_kernel_normalized():
    for var in (0.01, 0.5, 2.0, 10.0):
        k = imops.gaussian_kernel(4, var)
        assert abs(k.sum() - 1.0) < 1e-6
        assert np.all(k[:4] == k[:-5:-1])  # symmetric


def test_scale_down_shape(rng):
    img = rng.normal(size=(64, 80)).astype(np.float32)
    out = imops.scale_down(jnp.asarray(img))
    assert out.shape == (32, 40)


def test_bilinear_sample_exact_and_interp(rng):
    img = rng.normal(size=(16, 16)).astype(np.float32)
    j = jnp.asarray(img)
    # Integer coords hit pixels exactly
    v = imops.bilinear_sample(j, jnp.asarray([3.0]), jnp.asarray([5.0]))
    assert abs(float(v[0]) - img[5, 3]) < 1e-6
    # Halfway between two pixels
    v = imops.bilinear_sample(j, jnp.asarray([3.5]), jnp.asarray([5.0]))
    assert abs(float(v[0]) - 0.5 * (img[5, 3] + img[5, 4])) < 1e-6


def test_pyramid_structure(rng):
    img = rng.normal(size=(64, 64)).astype(np.float32) * 10
    cfg = SiftConfig(num_octaves=3)
    octs = pyramid.build_pyramid(jnp.asarray(img), cfg)
    assert len(octs) == 3
    assert octs[0].dog.shape == (cfg.num_scales + 2, 64, 64)
    assert octs[1].dog.shape == (cfg.num_scales + 2, 32, 32)
    assert octs[0].subsampling == 1.0 and octs[2].subsampling == 4.0


def _blob_image(H, W, centers, noise_rng=None):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W), np.float32)
    for cy, cx, s, a in centers:
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    if noise_rng is not None:
        img += noise_rng.normal(scale=0.5, size=(H, W)).astype(np.float32)
    return img


def test_detect_blobs(rng):
    centers = [(32.3, 40.7, 3.0, 200.0), (80.2, 90.5, 5.0, 180.0), (100.1, 30.4, 2.0, 220.0)]
    img = _blob_image(128, 128, centers, rng)
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=128)
    res = frontend.extract_sift(jnp.asarray(img), cfg)
    kp = res.keypoints
    v = np.array(kp.valid)
    assert v.sum() >= 3
    xs, ys = np.array(kp.x)[v], np.array(kp.y)[v]
    for cy, cx, s, a in centers:
        d = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        assert d.min() < 0.5, f"blob at ({cx},{cy}) missed (nearest {d.min():.2f})"


def test_orientation_gradient_direction():
    # Image with a pure horizontal ramp -> gradient points +x.  In the
    # reference's bin convention (bin = 16*theta/pi + 16.5, orientation
    # = 11.25*bin, cudaSiftD.cu:998-1000,1035-1038) a +x gradient lands
    # at 180 degrees; what matters is cross-image consistency.
    H = W = 32
    img = np.tile(np.arange(W, dtype=np.float32) * 10, (H, 1))
    x = jnp.asarray([16.0])
    y = jnp.asarray([16.0])
    sc = jnp.asarray([1.5])
    ori1, _, _ = orient.assign_orientations(
        jnp.asarray(img), x, y, sc, jnp.asarray([True])
    )
    o = float(ori1[0])
    assert abs(o - 180.0) < 12.0, o  # within one bin of 180 deg


def test_orientation_duplicate_on_two_peaks():
    # Checkerboard-ish pattern with two strong opposite gradients.
    H = W = 48
    xx = np.arange(W, dtype=np.float32)
    img = np.tile(100.0 * np.abs((xx % 16) - 8), (H, 1)).astype(np.float32)
    ori1, ori2, valid2 = orient.assign_orientations(
        jnp.asarray(img), jnp.asarray([24.0]), jnp.asarray([24.0]),
        jnp.asarray([2.0]), jnp.asarray([True]),
    )
    # Gradients point both +x and -x equally -> second peak fires.
    assert bool(valid2[0])
    diff = abs(float(ori1[0]) - float(ori2[0])) % 360
    assert min(diff, 360 - diff) > 150  # ~opposite orientations


def test_descriptor_shift_invariance(rng):
    centers = [(40.25, 40.75, 4.0, 150.0), (43.0, 52.0, 2.0, 80.0), (52.0, 44.0, 3.0, 60.0)]
    img1 = _blob_image(96, 96, centers)
    shifted = [(cy + 7.0, cx + 5.0, s, a) for cy, cx, s, a in centers]
    img2 = _blob_image(96, 96, shifted)
    d1 = describe.extract_descriptors(
        jnp.asarray(img1), jnp.asarray([40.75]), jnp.asarray([40.25]),
        jnp.asarray([2.0]), jnp.asarray([0.0]),
    )
    d2 = describe.extract_descriptors(
        jnp.asarray(img2), jnp.asarray([45.75]), jnp.asarray([47.25]),
        jnp.asarray([2.0]), jnp.asarray([0.0]),
    )
    corr = float((np.array(d1) @ np.array(d2).T).item())
    assert corr > 0.999


def test_descriptor_rotation_invariance(rng):
    # A structured patch rotated by 90 deg; with orientations offset by
    # 90 the descriptors must agree closely.
    img = rng.normal(size=(64, 64)).astype(np.float32) * 50
    img = np.array(imops.blur(jnp.asarray(img), imops.gaussian_kernel(4, 2.0)))
    rot = np.rot90(img, k=-1).copy()  # (x,y) -> (W-1-y, x)
    cx, cy = 30.0, 26.0
    rcx, rcy = 63.0 - cy, cx
    d1 = describe.extract_descriptors(
        jnp.asarray(img), jnp.asarray([cx]), jnp.asarray([cy]),
        jnp.asarray([2.0]), jnp.asarray([10.0]),
    )
    d2 = describe.extract_descriptors(
        jnp.asarray(rot), jnp.asarray([rcx]), jnp.asarray([rcy]),
        jnp.asarray([2.0]), jnp.asarray([100.0]),
    )
    corr = float((np.array(d1) @ np.array(d2).T).item())
    assert corr > 0.97, corr


def test_match_planted(rng):
    # Random unit descriptors; set2 = permuted copies of set1 + noise.
    n1, n2 = 200, 300
    d1 = rng.normal(size=(n1, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    perm = rng.permutation(n2)[:n1]
    d2 = rng.normal(size=(n2, 128)).astype(np.float32) * 0.1
    d2[perm] += d1 * 2.0
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m = match_mod.match(jnp.asarray(d1), jnp.asarray(d2))
    idx = np.array(m.index)
    assert (idx == perm).mean() > 0.99
    assert np.array(m.valid).mean() > 0.9
    assert np.all(np.array(m.ambiguity) <= 1.0 + 1e-5)


def test_match_chunking_consistency(rng):
    d1 = rng.normal(size=(64, 128)).astype(np.float32)
    d2 = rng.normal(size=(500, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    b1, s1, i1 = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), chunk=128
    )
    scores = d1 @ d2.T
    np.testing.assert_allclose(np.array(b1), scores.max(1), atol=1e-5)
    np.testing.assert_array_equal(np.array(i1), scores.argmax(1))
    part = np.partition(scores, -2, axis=1)
    np.testing.assert_allclose(np.array(s1), part[:, -2], atol=1e-5)


def test_match_mutual(rng):
    d1 = rng.normal(size=(50, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([d1, d1])  # every left point is ambiguous
    m = match_mod.match(
        jnp.asarray(d1), jnp.asarray(d2), cfg=MatchConfig(max_ambiguity=0.8)
    )
    # duplicates -> ambiguity ~1 -> all invalid
    assert not np.array(m.valid).any()


@pytest.mark.parametrize("variances", [(0.3, 1.0, 2.7), (0.0, 4.0)])
def test_blur_bank_matches_numpy(variances):
    # The grouped-conv blur bank against the definitional separable
    # blur per plane (float64 numpy, edge clamp).
    rng2 = np.random.default_rng(11)
    img = rng2.normal(size=(48, 71)).astype(np.float32) * 40 + 100
    bank = np.stack([imops.gaussian_kernel(4, v) for v in variances])
    out = np.array(imops.blur_bank(jnp.asarray(img), bank))
    ref = np.stack([_np_blur(img.astype(np.float64), t) for t in bank])
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-3, np.abs(out - ref).max()


@pytest.mark.slow
def test_detect_compact_select_matches_topk():
    # Below capacity, scan-order compaction must select the SAME
    # keypoint set as exact top-k (order may differ).
    import dataclasses
    import jax.numpy as jnp
    from sfm_jax.io.image_io import load_gray
    from sfm_jax.config import SiftConfig
    from sfm_jax.sift import frontend

    img = jnp.asarray(
        load_gray("/root/reference/data/dino/viff.000.ppm")[40:360, 100:612])
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=1024, sample_cap=0)
    a = frontend.extract_sift(img, cfg)
    b = frontend.extract_sift(
        img, dataclasses.replace(cfg, select="compact"))
    for r in (a, b):
        assert int(np.array(r.keypoints.valid).sum()) > 100
    ka = np.stack([np.array(a.keypoints.x)[np.array(a.keypoints.valid)],
                   np.array(a.keypoints.y)[np.array(a.keypoints.valid)]], 1)
    kb = np.stack([np.array(b.keypoints.x)[np.array(b.keypoints.valid)],
                   np.array(b.keypoints.y)[np.array(b.keypoints.valid)]], 1)
    ia, ib = np.lexsort(ka.T), np.lexsort(kb.T)
    assert ka.shape == kb.shape
    assert np.allclose(ka[ia], kb[ib], atol=1e-4)


def test_detect_capacity_exceeds_octave_pixels():
    # 32K-class configs give coarse octaves fewer pixels than slots
    # (tools/bench_capacity.py); detection must clamp + pad, not crash.
    import jax.numpy as jnp
    from sfm_jax.sift import frontend
    from sfm_jax.config import SiftConfig

    rng2 = np.random.default_rng(3)
    img = jnp.asarray(rng2.normal(size=(96, 128)).astype(np.float32) * 20 + 100)
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=4096, sample_cap=512)
    r = frontend.extract_sift(img, cfg)
    v = np.array(r.keypoints.valid)
    # sample_cap bounds the sampled slots (x2 for orientation dups).
    assert r.descriptors.shape[0] <= 2 * 512
    assert v.sum() >= 0  # ran without shape errors; validity coherent
    assert np.isfinite(np.array(r.keypoints.x)[v]).all()


def test_scale_down_matches_numpy():
    # Blur with the 5-tap sigma^2=0.5 kernel, then keep even pixels.
    rng2 = np.random.default_rng(7)
    img = rng2.normal(size=(64, 90)).astype(np.float32) * 30 + 90
    taps = imops.gaussian_kernel(2, 0.5)
    out = np.array(imops.scale_down(jnp.asarray(img)))
    ref = _np_blur(img.astype(np.float64), taps)[0::2, 0::2]
    assert out.shape == ref.shape == (32, 45)
    assert np.abs(out - ref).max() < 1e-3, np.abs(out - ref).max()


def test_lowpass_matches_numpy():
    # The prefilter: sigma = init_blur, truncated at lowpass_radius.
    rng2 = np.random.default_rng(9)
    img = rng2.normal(size=(72, 96)).astype(np.float32) * 30 + 90
    cfg = SiftConfig(max_pts_per_octave=128, num_octaves=2)
    taps = imops.gaussian_kernel(cfg.lowpass_radius, cfg.init_blur ** 2)
    out = np.array(pyramid.lowpass(jnp.asarray(img), cfg))
    ref = _np_blur(img.astype(np.float64), taps)
    assert np.abs(out - ref).max() < 1e-3, np.abs(out - ref).max()
