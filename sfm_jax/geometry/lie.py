"""SO(3)/SE(3) Lie-group operations (batched, f32, branch-free).

No reference counterpart — the reference never optimizes on a manifold
(it has no bundle adjustment, README.md:42).  These are the building
blocks for relative-pose refinement and BA.
"""

from __future__ import annotations

import jax.numpy as jnp

from sfm_jax.ops.linalg import cross_matrix


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation.

    Taylor-guarded at theta ~ 0 so it is safe under jit and autodiff.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = cross_matrix(w)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta in [0, pi))."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of the skew part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    # theta/(2 sin theta) with series at 0; near pi fall back to the
    # diagonal-based extraction.
    scale = jnp.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,
        theta / jnp.maximum(2.0 * sin_t, 1e-12),
    )
    w = v * scale[..., None]
    # Near theta = pi, v ~ 0; use sqrt of diagonal entries instead.
    near_pi = theta > 3.0
    d = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis = jnp.sqrt(jnp.maximum((d - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), 0.0))
    # Fix signs from off-diagonals.
    sign = jnp.stack(
        [
            jnp.sign(R[..., 2, 1] - R[..., 1, 2]),
            jnp.sign(R[..., 0, 2] - R[..., 2, 0]),
            jnp.sign(R[..., 1, 0] - R[..., 0, 1]),
        ],
        axis=-1,
    )
    sign = jnp.where(sign == 0, 1.0, sign)
    w_pi = axis * sign * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w)


def tangent_basis(t):
    """Orthonormal basis [..., 3, 2] of the plane perpendicular to t.

    Branch-free householder-style construction; t need not be unit.
    """
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    # Pick the axis least aligned with t to seed the basis.
    a = jnp.where(
        (jnp.abs(t[..., 0:1]) < 0.9),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], t.dtype), t.shape),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], t.dtype), t.shape),
    )
    b1 = jnp.cross(t, a)
    b1 = b1 / jnp.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = jnp.cross(t, b1)
    return jnp.stack([b1, b2], axis=-1)
