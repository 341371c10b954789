"""Tests for metrics (Umeyama/ATE), checkpointing, homography, CLI-level
IO pieces."""

import numpy as np
import jax
import jax.numpy as jnp

from helpers import rot
from sfm_jax.utils import metrics, checkpoint
from sfm_jax.geometry import homography


def test_umeyama_recovers_similarity(rng):
    src = rng.normal(size=(50, 3))
    R = rot([0.3, 0.5, 1.0], 0.7)
    s, t = 2.5, np.array([1.0, -2.0, 0.5])
    dst = s * src @ R.T + t
    s_e, R_e, t_e = metrics.umeyama_alignment(src, dst)
    assert abs(s_e - s) < 1e-9
    assert np.abs(R_e - R).max() < 1e-9
    assert np.abs(t_e - t).max() < 1e-9


def test_ate_zero_for_similarity_transformed(rng):
    M = 8
    R_gt = np.stack([rot([0, 1, 0], 0.1 * i) for i in range(M)])
    t_gt = rng.normal(size=(M, 3))
    # Estimated = same trajectory in a rotated/scaled frame
    S = rot([1, 0, 0], 0.4)
    R_est = np.einsum("mij,jk->mik", R_gt, S.T)
    centers = metrics.camera_centers(R_gt, t_gt)
    c_est = 3.0 * centers @ S.T + np.array([5.0, 0, 0])
    t_est = -np.einsum("mij,mj->mi", R_est, c_est)
    rmse, err = metrics.ate_rmse(R_est, t_est, R_gt, t_gt)
    assert rmse < 1e-6


def test_ate_detects_error(rng):
    M = 6
    R_gt = np.stack([rot([0, 1, 0], 0.1 * i) for i in range(M)])
    t_gt = rng.normal(size=(M, 3))
    t_bad = t_gt + rng.normal(scale=0.2, size=t_gt.shape)
    rmse, _ = metrics.ate_rmse(R_gt, t_bad, R_gt, t_gt)
    assert rmse > 0.01


def test_checkpoint_roundtrip(tmp_path, rng):
    from sfm_jax.models.incremental import MapState

    state = MapState(
        X=jnp.asarray(rng.normal(size=(10, 3)).astype(np.float32)),
        X_valid=jnp.asarray(rng.random(10) > 0.5),
        n_points=jnp.asarray(5, jnp.int32),
        R=jnp.asarray(np.stack([np.eye(3, dtype=np.float32)] * 3)),
        t=jnp.asarray(rng.normal(size=(3, 3)).astype(np.float32)),
        pose_valid=jnp.asarray([True, True, False]),
        point_id=jnp.asarray(rng.integers(-1, 10, (3, 7)).astype(np.int32)),
    )
    p = tmp_path / "map.npz"
    checkpoint.save_map(p, state, extra={"K": [[1, 0, 0]]})
    loaded, extra = checkpoint.load_map(p)
    assert extra == {"K": [[1, 0, 0]]}
    for a, b in zip(state, loaded):
        np.testing.assert_array_equal(np.array(a), np.array(b))


def test_homography_ransac(rng):
    H_gt = np.array(
        [[1.1, 0.05, 10.0], [-0.03, 0.95, -5.0], [1e-4, -5e-5, 1.0]], np.float64
    )
    n = 300
    uv1 = rng.uniform(0, 500, size=(n, 2))
    ph = np.concatenate([uv1, np.ones((n, 1))], axis=1) @ H_gt.T
    uv2 = ph[:, :2] / ph[:, 2:3]
    uv2 += rng.normal(scale=0.3, size=uv2.shape)
    n_out = 60
    uv2[:n_out] = rng.uniform(0, 500, size=(n_out, 2))
    res = homography.ransac_homography(
        jax.random.PRNGKey(0),
        jnp.asarray(uv1.astype(np.float32)),
        jnp.asarray(uv2.astype(np.float32)),
        n_hyps=512, threshold=4.0,
    )
    inl = np.array(res.inliers)
    assert inl[:n_out].sum() <= 3
    assert inl[n_out:].mean() > 0.9
    H = np.array(res.H, np.float64)
    H = H / H[2, 2]
    assert np.abs(H - H_gt).max() / np.abs(H_gt).max() < 0.01


def test_improve_homography_reference_metric(rng):
    """The reference's numFit pipeline (geomFuncs.cpp:6-73): a loose
    5 px RANSAC seed + 5 unconditional 3 px improve loops must converge
    to the ground-truth H even when the seed gate admitted outliers."""
    H_gt = np.array(
        [[1.05, 0.02, 8.0], [-0.02, 0.98, -3.0], [5e-5, -2e-5, 1.0]],
        np.float64,
    )
    n = 400
    uv1 = rng.uniform(0, 800, size=(n, 2))
    ph = np.concatenate([uv1, np.ones((n, 1))], axis=1) @ H_gt.T
    uv2 = ph[:, :2] / ph[:, 2:3]
    uv2 += rng.normal(scale=0.4, size=uv2.shape)
    n_out = 120
    uv2[:n_out] = rng.uniform(0, 800, size=(n_out, 2))
    u1 = jnp.asarray(uv1.astype(np.float32))
    u2 = jnp.asarray(uv2.astype(np.float32))
    res = homography.ransac_homography(
        jax.random.PRNGKey(0), u1, u2,
        n_hyps=1024, threshold=25.0, refit_iters=0,
    )
    H = homography.improve_homography(
        res.H, u1, u2, jnp.ones((n,), bool), loops=5, threshold=9.0,
    )
    errs = np.array(homography.transfer_errors(H, u1, u2))
    # All true inliers fit at 3 px; outliers don't sneak in.
    assert (errs[n_out:] < 9.0).mean() > 0.97
    assert (errs[:n_out] < 9.0).mean() < 0.05
    Hn = np.array(H, np.float64)
    assert np.abs(Hn / Hn[2, 2] - H_gt).max() / np.abs(H_gt).max() < 0.01


def test_native_io_rejects_malformed(tmp_path, rng):
    # Regression for the r1 advisor finding: mixed-size batches and
    # truncated payloads must fail cleanly, never write out of bounds.
    from sfm_jax.io import native

    if not native.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    small = (rng.random((8, 10)) * 255).astype(np.uint8)
    big = (rng.random((64, 80)) * 255).astype(np.uint8)
    ps = tmp_path / "small.pgm"
    pb = tmp_path / "big.pgm"
    ps.write_bytes(b"P5\n10 8\n255\n" + small.tobytes())
    pb.write_bytes(b"P5\n80 64\n255\n" + big.tobytes())
    # Batch where a LARGER image follows the first: must error or skip,
    # not overflow the stride slot.
    import pytest

    with pytest.raises(Exception):
        native.load_gray_batch([ps, pb])
    # Truncated payload.
    pt = tmp_path / "trunc.pgm"
    pt.write_bytes(b"P5\n10 8\n255\n" + small.tobytes()[: 10 * 4])
    with pytest.raises(Exception):
        native.load_gray(pt)
    # Absurd header dimensions (size_t wrap guard).
    ph = tmp_path / "huge.pgm"
    ph.write_bytes(b"P5\n4294967295 4294967295\n255\n\x00")
    with pytest.raises(Exception):
        native.load_gray(ph)


def test_native_io_roundtrip(tmp_path, rng):
    from sfm_jax.io import native

    if not native.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    # PGM write via python, read via native
    img = (rng.random((24, 32)) * 255).astype(np.uint8)
    p = tmp_path / "t.pgm"
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n32 24\n255\n")
        f.write(img.tobytes())
    a = native.load_gray(p)
    np.testing.assert_allclose(a, img.astype(np.float32), atol=1e-4)
    # PLY export
    pts = rng.random((20, 3)).astype(np.float32)
    valid = (rng.random(20) > 0.3).astype(np.uint8)
    out = tmp_path / "c.ply"
    n = native.save_ply(out, pts, valid=valid)
    assert n == valid.sum()
    head = out.read_bytes()[:200]
    assert f"element vertex {n}".encode() in head


def _write_seq(tmp_path, rng, n=9, h=12, w=16):
    paths = []
    for i in range(n):
        img = (rng.random((h, w)) * 255).astype(np.uint8)
        img[0, 0] = i  # frame-identifying pixel
        p = tmp_path / f"frame{i:02d}.pgm"
        p.write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        paths.append(p)
    return paths


def test_prefetcher_in_order_and_matches_load_gray(tmp_path, rng):
    from sfm_jax.io import image_io, native

    paths = _write_seq(tmp_path, rng)
    golden = [image_io.load_gray(p) for p in paths]
    # Native decode-ahead stream (skip silently to the fallback check
    # if the toolchain is unavailable).
    if native.available():
        got = list(native.FramePrefetcher(paths, depth=3, n_threads=2))
        assert [i for i, _ in got] == list(range(len(paths)))
        for (i, a), g in zip(got, golden):
            np.testing.assert_allclose(a, g)
    # iter_gray_frames dispatches native-or-fallback; same contract.
    got2 = list(image_io.iter_gray_frames(paths, depth=3))
    assert [i for i, _ in got2] == list(range(len(paths)))
    for (i, a), g in zip(got2, golden):
        np.testing.assert_allclose(a, g)


def test_prefetcher_python_fallback(tmp_path, rng, monkeypatch):
    from sfm_jax.io import image_io, native

    paths = _write_seq(tmp_path, rng, n=5)
    golden = [image_io.load_gray(p) for p in paths]
    monkeypatch.setattr(native, "available", lambda: False)
    got = list(image_io.iter_gray_frames(paths, depth=2))
    assert [i for i, _ in got] == list(range(len(paths)))
    for (i, a), g in zip(got, golden):
        np.testing.assert_allclose(a, g)


def test_prefetcher_decode_failure_raises(tmp_path, rng):
    from sfm_jax.io import native

    if not native.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    paths = _write_seq(tmp_path, rng, n=4)
    # Corrupt frame 2 with a mismatched size (truncated payload).
    paths[2].write_bytes(b"P5\n16 12\n255\n" + b"\x00" * 10)
    pf = native.FramePrefetcher(paths, depth=2)
    import pytest

    next(pf)
    next(pf)
    with pytest.raises(ValueError):
        next(pf)
    pf.close()
