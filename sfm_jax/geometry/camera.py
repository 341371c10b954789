"""Camera intrinsics and point normalization.

Equivalent of the reference's ``fillXU`` stage
(reference SfM/sfm.cu:80-92): gather matched keypoint pixel coordinates
into dense homogeneous arrays and normalize by K^{-1}.  Here points live
as SoA ``[N, 3]`` arrays (static N with validity masks) instead of the
reference's AoS ``SiftPoint`` device structs.
"""

from __future__ import annotations

import jax.numpy as jnp


def intrinsics(fx, fy=None, cx=0.0, cy=0.0, skew=0.0, dtype=jnp.float32):
    """Build a 3x3 intrinsic matrix K (reference src/main.cpp:292-297)."""
    if fy is None:
        fy = fx
    return jnp.asarray(
        [[fx, skew, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype
    )


def inv_intrinsics(K):
    """Closed-form inverse of an upper-triangular K."""
    fx = K[0, 0]
    s = K[0, 1]
    cx = K[0, 2]
    fy = K[1, 1]
    cy = K[1, 2]
    return jnp.asarray(
        [
            [1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)],
            [0.0, 1.0 / fy, -cy / fy],
            [0.0, 0.0, 1.0],
        ],
        dtype=K.dtype,
    )


def to_homogeneous(uv):
    """[..., 2] pixel coords -> [..., 3] homogeneous."""
    return jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)


def normalize_points(uv, K_inv):
    """x = K^{-1} u for pixel coords ``uv`` [..., 2] -> [..., 3].

    The X = K^{-1} U GEMM of the reference (SfM/sfm.cu:88-91).
    """
    u = to_homogeneous(uv)
    return u @ K_inv.T


def project(X, R, t, K=None):
    """Project world points [..., 3] by (R, t) and optional K.

    Returns pixel (or normalized-plane) coords [..., 2] and depth [...].
    """
    Xc = X @ R.T + t
    depth = Xc[..., 2]
    if K is not None:
        Xc = Xc @ K.T
    uv = Xc[..., :2] / jnp.where(jnp.abs(depth[..., None]) < 1e-12, 1e-12, Xc[..., 2:3])
    return uv, depth
