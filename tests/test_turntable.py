"""Tests for turntable-constrained reconstruction + track building.

Pins the r2 failure mode: a bas-relief-collapsed chain (rotations
compressed ~2x, radius inflated chord-preservingly) must be recovered
to the true uniform circular motion by fit_turntable + refine_turntable
using only the image observations. See models/turntable.py for why the
constraint is justified on turntable data (loop closure + gap-symmetric
match survival).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp

from helpers import rot
from sfm_jax.geometry import triangulate as tri
from sfm_jax.models import turntable as tt


N_FRAMES = 12
STEP = 2 * math.pi / N_FRAMES
RADIUS = 5.0
AXIS = np.array([0.05, 1.0, 0.02]) / np.linalg.norm([0.05, 1.0, 0.02])


def _true_scene(rng, n_pts=250):
    """Cameras orbit the origin about AXIS; points near the origin."""
    X = rng.uniform(-0.8, 0.8, size=(n_pts, 3)).astype(np.float32)
    center = np.zeros(3, np.float32)
    C0 = center + RADIUS * np.array([0.0, 0.0, -1.0], np.float32)
    # look-at base rotation: camera z towards the center
    z = (center - C0) / np.linalg.norm(center - C0)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R0 = np.stack([x, y, z]).astype(np.float32)
    Rs, ts = [], []
    for i in range(N_FRAMES):
        Rot_i = rot(AXIS, STEP * i).astype(np.float32)
        Ci = center + Rot_i @ (C0 - center)
        Ri = R0 @ Rot_i.T
        Rs.append(Ri)
        ts.append(-Ri @ Ci)
    return np.stack(Rs), np.stack(ts), X


F_PX = 1800.0
C_PX = (360.0, 288.0)
K_SYN = np.array([[F_PX, 0, C_PX[0]], [0, F_PX, C_PX[1]], [0, 0, 1]],
                 np.float32)


def _observations(R, t, X, rng, noise=3e-4, k1=0.0):
    M, P = R.shape[0], X.shape[0]
    cam_idx = np.repeat(np.arange(M), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), M).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:3]
    uv = (uv + rng.normal(scale=noise, size=uv.shape)).astype(np.float32)
    r2 = (uv ** 2).sum(1, keepdims=True)
    uv_pix = (C_PX + F_PX * uv * (1.0 + k1 * r2)).astype(np.float32)
    return (jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(uv),
            jnp.asarray(uv_pix), jnp.ones((len(uv),), bool))


def _collapse(R, t, factor=0.45):
    """Bas-relief-style corruption: compress every step's rotation by
    `factor` about the same axes while keeping chords (translation
    magnitudes) — the empirical failure shape on the dino data."""
    from sfm_jax.geometry import lie

    M = R.shape[0]
    C = -np.einsum("mij,mi->mj", R, t)
    Rc = [R[0]]
    Cc = [C[0]]
    for i in range(1, M):
        dR = R[i - 1].T @ R[i]
        rv = np.asarray(lie.so3_log(jnp.asarray(dR)))
        dRc = rot(rv / np.linalg.norm(rv), np.linalg.norm(rv) * factor)
        Rc.append(Rc[-1] @ dRc)
        # keep the chord (translation magnitude survives the collapse)
        Cc.append(Cc[-1] + (C[i] - C[i - 1]))
    Rc = np.stack(Rc).astype(np.float32)
    Cc = np.stack(Cc).astype(np.float32)
    tc = -np.einsum("mij,mj->mi", Rc, Cc)
    return Rc, tc


def _steps_deg(R):
    R = np.asarray(R)
    return np.array([
        math.degrees(math.acos(np.clip((np.trace(R[i] @ R[i - 1].T) - 1) / 2,
                                       -1, 1)))
        for i in range(1, len(R))
    ])


@pytest.mark.slow
def test_turntable_poses_roundtrip():
    R, t, _ = _true_scene(np.random.default_rng(0))
    model = tt.fit_turntable(jnp.asarray(R), jnp.asarray(t),
                             close_loop=False)
    phases = jnp.asarray(STEP * np.arange(N_FRAMES), jnp.float32)
    R2, t2 = tt.turntable_poses(model, phases)
    assert np.abs(np.asarray(R2) - R).max() < 1e-4
    assert np.abs(np.asarray(t2) - t).max() < 1e-4


def test_triangulate_tracks_recovers_points(rng):
    R, t, X = _true_scene(np.random.default_rng(1))
    ci, pi, uv, _, mask = _observations(R, t, X, np.random.default_rng(2),
                                        noise=0.0)
    X2, ok = tri.triangulate_tracks(jnp.asarray(R), jnp.asarray(t),
                                    ci, pi, uv, mask, X.shape[0])
    assert bool(np.asarray(ok).all())
    assert np.abs(np.asarray(X2) - X).max() < 1e-3


def test_refine_turntable_recovers_collapsed_chain():
    rng = np.random.default_rng(3)
    R, t, X = _true_scene(rng)
    ci, pi, _, uv_pix, mask = _observations(R, t, X, rng, k1=-0.15)
    Rc, tc = _collapse(R, t)
    total_c = _steps_deg(Rc).sum()
    assert total_c < 220.0  # corruption really collapsed the chain
    model = tt.fit_turntable(jnp.asarray(Rc), jnp.asarray(tc))
    model, intr, R2, t2, X2, keep, rms = tt.refine_turntable(
        model, ci, pi, uv_pix, mask, K_SYN,
        n_frames=N_FRAMES, n_points=X.shape[0], iters=12, tri_rounds=3,
    )
    ss = _steps_deg(R2)
    ideal = math.degrees(STEP)
    assert abs(ss.mean() - ideal) < 0.15, ss
    assert ss.std() < 0.1
    # Most observations survive the prune at the recovered geometry.
    assert int(np.asarray(keep).sum()) > 0.8 * len(np.asarray(keep))
    assert float(rms) < 1.5, float(rms)
    # The distortion that broke the pinhole chain is recovered
    # directionally (f/k1/k2 trade off in a narrow FOV, so only the
    # sign and rough magnitude are identifiable).
    assert float(intr[1]) < -0.05, float(intr[1])


@pytest.mark.slow
def test_reconstruct_turntable_end_to_end():
    """Productized driver: synthetic ring features (track-unique
    descriptors) + a collapsed chain -> recovered uniform rotation."""
    import types
    from sfm_jax.config import PipelineConfig

    rng = np.random.default_rng(11)
    R, t, X = _true_scene(rng, n_pts=160)
    P = X.shape[0]
    D = rng.normal(size=(P, 128)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    feats = []
    for i in range(N_FRAMES):
        Xc = X @ R[i].T + t[i]
        uv = Xc[:, :2] / Xc[:, 2:]
        pix = (C_PX + F_PX * uv
               + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
        Df = D + rng.normal(scale=0.05, size=D.shape).astype(np.float32)
        Df /= np.linalg.norm(Df, axis=1, keepdims=True)
        kp = types.SimpleNamespace(
            x=jnp.asarray(pix[:, 0]), y=jnp.asarray(pix[:, 1]),
            valid=jnp.ones((P,), bool),
        )
        feats.append(types.SimpleNamespace(
            keypoints=kp, descriptors=jnp.asarray(Df)))
    Rc, tc = _collapse(R, t)
    res = tt.reconstruct_turntable(
        feats, Rc, tc, K_SYN, PipelineConfig(),
        pose_valid=np.ones((N_FRAMES,), bool),
    )
    ss = np.asarray(res.step_deg)
    ideal = math.degrees(STEP)
    assert abs(ss.mean() - ideal) < 0.2, ss
    assert ss.std() < 0.3, ss
    assert abs(res.total_deg - 360.0) < 2.0, res.total_deg
    assert res.rms_px < 1.5, res.rms_px
    assert res.tracks.n_tracks >= 0.9 * P
    assert int(np.asarray(res.keep).sum()) > 0.8 * len(np.asarray(res.keep))
    # Missing-bootstrap-pair guard.
    import pytest
    with pytest.raises(ValueError):
        tt.reconstruct_turntable(
            feats, Rc, tc, K_SYN, PipelineConfig(),
            pose_valid=np.array([True, False] + [True] * (N_FRAMES - 2)),
        )


def test_ring_pairs_and_build_tracks_conflict_rule():
    from sfm_jax.models import tracks as tr

    pairs = tr.ring_pairs(6, gaps=(1, 2), wrap=True)
    assert (5, 0) in pairs and (4, 0) in pairs and len(pairs) == 12
    pairs_nw = tr.ring_pairs(6, gaps=(1,), wrap=False)
    assert (5, 0) not in pairs_nw and len(pairs_nw) == 5

    # Synthetic features: 3 frames x 4 slots, descriptors arranged so
    # slot k matches slot k everywhere; one conflicting extra match.
    import types
    from sfm_jax.config import PipelineConfig

    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)

    class KP:
        pass

    feats = []
    for i in range(3):
        kp = types.SimpleNamespace(
            x=jnp.asarray(np.arange(4, dtype=np.float32) * 10 + i * 3),
            y=jnp.asarray(np.full(4, 5.0, np.float32) + i),
            valid=jnp.ones((4,), bool),
        )
        feats.append(types.SimpleNamespace(
            keypoints=kp, descriptors=jnp.asarray(base)))
    ts = tr.build_tracks(feats, tr.ring_pairs(3, gaps=(1,), wrap=True),
                         PipelineConfig(), min_disparity_px=0.0)
    # 4 tracks, each spanning all 3 frames.
    assert ts.n_tracks == 4
    cams = np.asarray(ts.cam_idx)
    pts = np.asarray(ts.pt_idx)
    for p in range(4):
        assert sorted(cams[pts == p].tolist()) == [0, 1, 2]
