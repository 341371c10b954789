"""Tests for the two-view geometry core: 8-point, RANSAC, pose, DLT.

The observable contract mirrors the reference's debug-print parity
surface (reference SfM/sfm.cu:86-141, 268-336): intermediate E, chosen
pose, triangulated points — validated here against synthetic ground
truth instead of by eye.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_jax.geometry import epipolar, ransac, pose, triangulate as tri, refine
from helpers import synthetic_two_view, e_error, rot_angle_error, t_dir_error


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    return synthetic_two_view(rng, n_points=400, noise=3e-4, n_outliers=60)


def test_eight_point_noise_free():
    rng = np.random.default_rng(3)
    s = synthetic_two_view(rng, n_points=64, noise=0.0)
    # Minimal solve on 8 clean points (Hartley-normalized for f32).
    x1 = jnp.asarray(s["x1"])
    x2 = jnp.asarray(s["x2"])
    T1 = epipolar.normalizing_transform(x1)
    T2 = epipolar.normalizing_transform(x2)
    A = epipolar.eight_point_matrix(x1[:8] @ T1.T, x2[:8] @ T2.T)
    from sfm_jax.ops import linalg

    e = linalg.qr_nullvec(A[None])
    E = epipolar.denormalize_E(e.reshape(3, 3), T1, T2)
    E = linalg.project_to_essential(E)
    assert e_error(np.array(E), s["E"]) < 1e-3


def test_epipolar_residuals_zero_on_clean():
    rng = np.random.default_rng(4)
    s = synthetic_two_view(rng, n_points=100, noise=0.0)
    r = epipolar.epipolar_residuals(
        jnp.asarray(s["E"] * np.sqrt(2)), jnp.asarray(s["x1"]), jnp.asarray(s["x2"])
    )
    assert float(jnp.max(r)) < 1e-9


def test_epipolar_residuals_batched_shape(scene):
    E = jnp.broadcast_to(jnp.asarray(scene["E"]), (5, 3, 3))
    r = epipolar.epipolar_residuals(E, jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]))
    assert r.shape == (5, scene["x1"].shape[0])


def test_ransac_recovers_E(scene):
    res = ransac.ransac_essential(
        jax.random.PRNGKey(0),
        jnp.asarray(scene["x1"]),
        jnp.asarray(scene["x2"]),
        n_hyps=512,
        threshold=1e-5,
    )
    n = scene["x1"].shape[0]
    n_out = scene["n_outliers"]
    inl = np.array(res.inliers)
    # Outliers must be rejected; most true inliers retained.
    assert inl[:n_out].sum() <= 3
    assert inl[n_out:].sum() > 0.5 * (n - n_out)
    assert e_error(np.array(res.E), scene["E"]) < 0.05


def test_ransac_deterministic(scene):
    x1 = jnp.asarray(scene["x1"])
    x2 = jnp.asarray(scene["x2"])
    r1 = ransac.ransac_essential(jax.random.PRNGKey(5), x1, x2, n_hyps=256)
    r2 = ransac.ransac_essential(jax.random.PRNGKey(5), x1, x2, n_hyps=256)
    np.testing.assert_array_equal(np.array(r1.E), np.array(r2.E))


def test_pose_candidates_structure(scene):
    Rs, ts = pose.pose_candidates(jnp.asarray(scene["E"]))
    assert Rs.shape == (4, 3, 3) and ts.shape == (4, 3)
    dets = np.linalg.det(np.array(Rs))
    np.testing.assert_allclose(dets, 1.0, atol=1e-4)
    # Each candidate must reproduce E up to scale/sign.
    from sfm_jax.geometry.refine import essential_from_pose

    for i in range(4):
        Ei = np.array(essential_from_pose(Rs[i], ts[i]))
        assert e_error(Ei, scene["E"]) < 1e-3


def test_recover_pose_picks_cheirality(scene):
    res = ransac.ransac_essential(
        jax.random.PRNGKey(0),
        jnp.asarray(scene["x1"]),
        jnp.asarray(scene["x2"]),
        n_hyps=512,
        threshold=1e-5,
    )
    p = pose.recover_pose(
        res.E,
        jnp.asarray(scene["x1"]),
        jnp.asarray(scene["x2"]),
        weights=res.inliers.astype(jnp.float32),
    )
    assert rot_angle_error(np.array(p["R"]), scene["R"]) < 0.05
    assert t_dir_error(np.array(p["t"]), scene["t"]) < 0.08
    votes = np.array(p["votes"])
    assert votes.max() > 0.9 * float(res.num_inliers)


def test_refine_improves_pose(scene):
    res = ransac.ransac_essential(
        jax.random.PRNGKey(0),
        jnp.asarray(scene["x1"]),
        jnp.asarray(scene["x2"]),
        n_hyps=512,
        threshold=1e-5,
    )
    p = pose.recover_pose(
        res.E,
        jnp.asarray(scene["x1"]),
        jnp.asarray(scene["x2"]),
        weights=res.inliers.astype(jnp.float32),
    )
    ref = refine.refine_relative_pose(
        p["R"], p["t"], jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]),
        weights=res.inliers, iters=12,
    )
    assert float(ref.cost) <= float(ref.initial_cost) + 1e-12
    pre = rot_angle_error(np.array(p["R"]), scene["R"])
    post = rot_angle_error(np.array(ref.R), scene["R"])
    # Refinement minimizes robust Sampson cost; it must not move the pose
    # meaningfully away from truth and must land accurately.
    assert post <= max(1.5 * pre, 0.005)
    assert post < 0.01
    assert t_dir_error(np.array(ref.t), scene["t"]) < 0.02


def test_triangulate_exact():
    rng = np.random.default_rng(9)
    s = synthetic_two_view(rng, n_points=200, noise=0.0)
    P1 = tri.make_projection(jnp.eye(3), jnp.zeros(3))
    P2 = tri.make_projection(jnp.asarray(s["R"]), jnp.asarray(s["t"]))
    X, w, finite = tri.triangulate(
        jnp.asarray(s["x1"]), jnp.asarray(s["x2"]), P1, P2
    )
    X = np.array(X)
    assert np.abs(X - s["X"]).max() < 5e-3
    assert np.array(finite).all()


def test_triangulate_reprojection(scene):
    P1 = tri.make_projection(jnp.eye(3), jnp.zeros(3))
    P2 = tri.make_projection(jnp.asarray(scene["R"]), jnp.asarray(scene["t"]))
    X, _, _ = tri.triangulate(
        jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]), P1, P2
    )
    err = tri.reprojection_errors(
        X, jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]),
        jnp.asarray(scene["R"]), jnp.asarray(scene["t"]),
    )
    n_out = scene["n_outliers"]
    med = float(jnp.median(err[n_out:]))
    # residual ~ noise^2 scale
    assert med < 5e-6


def test_depths_positive_for_true_geometry(scene):
    P1 = tri.make_projection(jnp.eye(3), jnp.zeros(3))
    P2 = tri.make_projection(jnp.asarray(scene["R"]), jnp.asarray(scene["t"]))
    X, _, _ = tri.triangulate(
        jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]), P1, P2
    )
    n_out = scene["n_outliers"]
    z2 = np.array(tri.depths(X, jnp.asarray(scene["R"]), jnp.asarray(scene["t"])))
    assert (np.array(X)[n_out:, 2] > 0).mean() > 0.95
    assert (z2[n_out:] > 0).mean() > 0.95


def test_minimal_set_sampling_no_duplicates():
    rng = np.random.default_rng(7)
    # Floyd sampling: every minimal set has k distinct valid indices,
    # even when n_valid barely exceeds k.
    import jax
    import jax.numpy as jnp
    from sfm_jax.geometry.ransac import sample_minimal_sets

    for n, n_valid, k in [(64, 9, 8), (128, 128, 8), (200, 50, 6)]:
        mask = np.zeros(n, bool)
        mask[rng.choice(n, n_valid, replace=False)] = True
        idx = np.array(
            sample_minimal_sets(jax.random.PRNGKey(0), jnp.asarray(mask), 257, k=k)
        )
        assert idx.shape == (257, k)
        assert mask[idx].all(), "sampled an invalid index"
        for row in idx:
            assert len(set(row.tolist())) == k, row
