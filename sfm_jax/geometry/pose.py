"""Pose recovery from an essential matrix.

Replacement for the reference's ``computePosecandidates`` +
``choosePose`` (reference SfM/sfm.cu:238-307): the reference copies E to
the host, runs a CPU 3x3 SVD, builds 4 candidate poses in a kernel, then
does 4 *serial* host-side triangulate/invert/readback iterations testing
cheirality on a SINGLE point.  Here everything stays on device: batched
3x3 SVD, all 4 candidates triangulate ALL correspondences in one vmapped
solve, and the winner is an argmax over positive-depth counts — far more
robust than the reference's one-point test, and jit-fusable end to end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.geometry import triangulate as tri
from sfm_jax.utils.precision import f32_matmul

# W = Rz(+90deg), the twist used in E = [t]_x R factorization
# (reference SfM/kernels.h:357-385 builds the same four candidates).
_W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


@f32_matmul
def pose_candidates(E, *, sweeps: int = 8):
    """Four candidate (R, t) from E.

    Returns (Rs [..., 4, 3, 3], ts [..., 4, 3]).
    """
    U, _, V = linalg.svd3x3(E, sweeps=sweeps)
    # Enforce proper rotations: flip the last column where det < 0
    # (reference negates V on det(U V^T) < 0, SfM/sfm.cu:241-245).
    dU = jnp.linalg.det(U)
    dV = jnp.linalg.det(V)
    U = U.at[..., :, 2].multiply(jnp.where(dU < 0, -1.0, 1.0)[..., None])
    V = V.at[..., :, 2].multiply(jnp.where(dV < 0, -1.0, 1.0)[..., None])
    W = _W.astype(E.dtype)
    R1 = jnp.einsum("...ik,kl,...jl->...ij", U, W, V)
    R2 = jnp.einsum("...ik,lk,...jl->...ij", U, W, V)
    u3 = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([u3, -u3, u3, -u3], axis=-2)
    return Rs, ts


@functools.partial(jax.jit, static_argnames=("sweeps",))
@f32_matmul
def align_candidates(E, R_ref, t_ref, *, sweeps: int = 8):
    """Pick the (R, t) candidate of E closest to a reference pose.

    Used after on-manifold refinement: the Sampson objective cannot see
    the 4-fold (R, t) ambiguity, so the branch must be preserved from
    the pre-refinement cheirality vote — re-voting on the refined E can
    flip to the wrong branch when votes are marginal (observed on the
    dino's near-forward motion).
    """
    Rs, ts = pose_candidates(E, sweeps=sweeps)
    rot_score = jnp.einsum("cij,ij->c", Rs, R_ref)  # trace(R_c R_ref^T)
    t_score = ts @ t_ref
    best = jnp.argmax(rot_score + t_score)
    return Rs[best], ts[best]


@functools.partial(jax.jit, static_argnames=("sweeps",))
@f32_matmul
def recover_pose(E, x1, x2, weights=None, *, sweeps: int = 8):
    """Pick the cheirality-correct (R, t) among the 4 candidates of E.

    Args:
      E: [3, 3] essential matrix.
      x1, x2: [N, 3] normalized homogeneous correspondences.
      weights: optional [N] mask/weights (e.g. RANSAC inliers) for voting.

    Returns dict with R [3,3], t [3], index of winning candidate, and the
    per-candidate positive-depth vote counts [4].
    """
    Rs, ts = pose_candidates(E, sweeps=sweeps)  # [4,3,3], [4,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=E.dtype), Rs.shape)
    zero = jnp.zeros_like(ts)
    P1 = tri.make_projection(eye, zero)  # [4,3,4] identity cams
    P2 = tri.make_projection(Rs, ts)
    X, w, finite = tri.triangulate(
        x1[None], x2[None], P1, P2, sweeps=sweeps
    )  # [4, N, 3]
    z1 = X[..., 2]
    z2 = tri.depths(X, Rs, ts)  # [4, N]
    good = (z1 > 0) & (z2 > 0)
    if weights is None:
        votes = jnp.sum(good, axis=-1).astype(jnp.float32)
    else:
        votes = jnp.sum(good * weights[None, :], axis=-1)
    best = jnp.argmax(votes)
    return {
        "R": Rs[best],
        "t": ts[best],
        "index": best,
        "votes": votes,
        "points": X[best],
        "front": good[best],
        "finite": finite[best],
    }


# --- translation re-vote (r4) -------------------------------------------

@functools.lru_cache(maxsize=4)
def _fibonacci_sphere(m: int):
    """[m, 3] near-uniform unit directions (golden-angle spiral)."""
    import numpy as np

    i = np.arange(m) + 0.5
    phi = np.pi * (1.0 + 5.0 ** 0.5) * i
    z = 1.0 - 2.0 * i / m
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack(
        [r * np.cos(phi), r * np.sin(phi), z], -1
    ).astype(np.float32)


# [t]_x = sum_k t_k * _GEN[k] (generator matrices of so(3))
_GEN = jnp.asarray(
    [
        [[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
    ]
)


@functools.partial(jax.jit, static_argnames=("n_dirs",))
@f32_matmul
def cheirality_t_vote(R, x1, x2, mask, threshold, *, n_dirs: int = 1024):
    """Max-cheirality translation direction for a FIXED rotation.

    On rotation-dominant pairs (the dino turntable; any small-baseline
    pair) the Sampson objective is nearly flat in the translation
    direction: poses 125 deg apart in t (but < 1 deg in R) fit the
    epipolar constraints equally well, yet the bad ones put a third of
    the inliers behind a camera (r4 seed study — seeds 0/4/5 lost ~380
    of ~1070 points this way).  Local refinement cannot escape that
    valley; this searches it globally instead.

    The midpoint depths (triangulate.midpoint_depths) are LINEAR in
    C2 = -R^T t for fixed R, so cheirality over a bank of candidate
    directions is two [N, 3] x [3, M] matmuls; the epipolar-consistency
    term batches through epipolar_residuals' einsums.  Everything is
    batched matrix work — no data-dependent control flow.  The reference has no
    counterpart (its choosePose tests cheirality on ONE point,
    SfM/sfm.cu:266-301); this is what makes this pipeline's
    RANSAC+refine stable across seeds where the reference's is not.

    Args:
      R: [3, 3] rotation (the well-determined part of the pose).
      x1, x2: [N, 3] normalized homogeneous correspondences (a
        compacted-inlier subset is fine and ~8x cheaper).
      mask: [N] bool rows to count.
      threshold: epipolar residual gate (same units as RANSAC's).
      n_dirs: size of the Fibonacci direction bank (static).

    Returns dict with t [3] (the winning direction), E [3, 3]
    (= [t]_x R, normalized to ||E|| = sqrt(2)), score (i32 count), and
    ok [N] bool (per-point epipolar+cheirality support of the winner).
    """
    from sfm_jax.geometry import epipolar

    ts = jnp.asarray(_fibonacci_sphere(n_dirs))            # [M, 3]
    # Depth-sign coefficients: z1 = A @ C2, z2 = B @ C2.
    b = jnp.einsum("ji,nj->ni", R, x2)
    aa = jnp.sum(x1 * x1, -1)
    bb = jnp.sum(b * b, -1)
    ab = jnp.sum(x1 * b, -1)
    det = aa * bb - ab * ab
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    A = (bb[:, None] * x1 - ab[:, None] * b) / det[:, None]
    B = (ab[:, None] * x1 - aa[:, None] * b) / det[:, None]
    C2s = -(ts @ R)                                        # [M, 3]
    z1 = A @ C2s.T                                         # [N, M]
    z2 = B @ C2s.T
    Es = jnp.einsum("mk,kij,jl->mil", ts, _GEN, R)         # [M, 3, 3]
    Es = Es * (
        jnp.sqrt(2.0) / jnp.linalg.norm(Es, axis=(1, 2), keepdims=True)
    )
    res = epipolar.epipolar_residuals(Es, x1, x2)          # [M, N]
    ok = (res.T < threshold) & mask[:, None] & (z1 > 0) & (z2 > 0)
    score = jnp.sum(ok, axis=0)                            # [M]
    m = jnp.argmax(score)
    return {
        "t": ts[m],
        "E": Es[m],
        "score": score[m].astype(jnp.int32),
        "ok": ok[:, m],
    }
