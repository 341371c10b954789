"""SIFT descriptor extraction (128-D, 4x4 cells x 8 orientations).

Replacement for ExtractSiftDescriptorsCONSTNew
(reference CudaSift/cudaSiftD.cu:308-417): the reference's shared-memory
atomic trilinear binning becomes two matmuls — the spatial bilinear
weights are FIXED per grid index, so they are a constant [16, 4] matrix
contraction; only the 8-way angle interpolation is data-dependent.

Behavioral parity:
  * 16x16 sample grid rotated by the keypoint orientation, spacing
    12/16 * scale (:331-339)
  * gradients by rotated unit-step central differences (:340-344)
  * Gaussian weight exp(-(t-7.5)^2/128) per axis (:317-318)
  * angle bins 4/pi*atan2+4 with linear interpolation across 8 bins
    (:345-356)
  * bilinear spatial weights with border truncation (tx>=2 / tx<=13
    guards, :361-385)
  * normalize, clamp at 0.2, renormalize (:389-409)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sfm_jax.ops.image import bilinear_sample


def _spatial_weight_matrix() -> np.ndarray:
    """Constant [16, 4] bilinear cell weights per grid index.

    Row i gives the weight of sample index i in each of the 4 cells
    along one axis, reproducing the reference's hori/horf logic
    (cudaSiftD.cu:348-351) including the edge truncation (:361, :375).
    """
    W = np.zeros((16, 4), np.float32)
    for i in range(16):
        ci = (i + 2) // 4 - 1
        f = (i - 1.5) / 4.0 - ci
        if i >= 2 and 0 <= ci <= 3:
            W[i, ci] = 1.0 - f
        if i <= 13 and 0 <= ci + 1 <= 3:
            W[i, ci + 1] = f
    return W


_W_SPATIAL = _spatial_weight_matrix()
_GAUSS16 = np.exp(-((np.arange(16) - 7.5) ** 2) / 128.0).astype(np.float32)


def normalize_descriptors(desc):
    """Two-pass normalization with 0.2 clamp (cudaSiftD.cu:389-409)."""
    n1 = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True))
    desc = jnp.minimum(desc / jnp.maximum(n1, 1e-12), 0.2)
    n2 = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True))
    return desc / jnp.maximum(n2, 1e-12)


def extract_descriptors(img, x, y, scale, orientation_deg):
    """[K, 128] L2-normalized SIFT descriptors.

    Layout matches the reference buffer: index = 8*(4*row_cell +
    col_cell) + angle_bin (cudaSiftD.cu:357-359), so descriptors are
    directly comparable.
    """
    theta = orientation_deg * (2.0 * jnp.pi / 360.0)
    cosa = jnp.cos(theta)
    sina = jnp.sin(theta)
    s = (12.0 / 16.0) * scale
    idx = jnp.arange(16, dtype=jnp.float32) - 7.5
    # Grid: i = column index (tx), j = row index (y); [K, 16(j), 16(i)]
    gi = idx[None, None, :]
    gj = idx[None, :, None]
    ca = cosa[:, None, None]
    sa = sina[:, None, None]
    ss = s[:, None, None]
    px = x[:, None, None] + ss * (gi * ca - gj * sa)
    py = y[:, None, None] + ss * (gi * sa + gj * ca)
    dx = bilinear_sample(img, px + ca, py + sa) - bilinear_sample(img, px - ca, py - sa)
    dy = bilinear_sample(img, px - sa, py + ca) - bilinear_sample(img, px + sa, py - ca)
    g16 = jnp.asarray(_GAUSS16)
    grad = g16[None, :, None] * g16[None, None, :] * jnp.sqrt(dx * dx + dy * dy)
    ang = 4.0 / jnp.pi * jnp.arctan2(dy, dx) + 4.0  # [0, 8)
    angi = jnp.clip(jnp.floor(ang), 0, 7)
    angf = ang - angi
    angi = angi.astype(jnp.int32)
    bins8 = jnp.arange(8)
    onehot1 = (angi[..., None] == bins8).astype(jnp.float32) * (1.0 - angf[..., None])
    onehot2 = (((angi + 1) % 8)[..., None] == bins8).astype(jnp.float32) * angf[..., None]
    T = grad[..., None] * (onehot1 + onehot2)  # [K, 16, 16, 8]
    Wsp = jnp.asarray(_W_SPATIAL)
    tmp = jnp.einsum("kjia,jc->kcia", T, Wsp)     # row cells
    desc = jnp.einsum("kcia,id->kcda", tmp, Wsp)  # col cells -> [K,4,4,8]
    desc = desc.reshape(desc.shape[0], 128)
    return normalize_descriptors(desc)
