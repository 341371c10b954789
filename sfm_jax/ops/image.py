"""Dense image ops: separable Gaussian filtering, resampling, gradients.

Replacement for the reference's shared-memory convolution kernels
(reference CudaSift/cudaSiftD.cu:84-168 ScaleDown, :1986-2037
LowPassBlock, :1753-1793 LaplaceMultiMem): images are ``[H, W]`` f32
arrays, filtering is expressed as XLA convolutions over an edge-clamped
pad (the reference clamps reads at borders), and the multi-scale blur
bank runs as ONE grouped convolution over all 8 scale planes.

Every blur runs at BLUR_PRECISION.  The blurs feed the DoG, a
difference of near-equal images thresholded at ~1/255 of the range, and
reduced-precision passes (bf16 or TF32 tensor-core products, ~3
decimal digits) inject phantom extrema there.  HIGHEST keeps true f32
products on the GPU.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

BLUR_PRECISION = jax.lax.Precision.HIGHEST


def gaussian_kernel(radius: int, variance: float) -> np.ndarray:
    """Truncated, normalized Gaussian taps [2r+1] (host-side constant).

    Matches the reference's kernel construction (truncate at radius,
    normalize by the truncated sum — reference CudaSift/cudaSiftH.cu:
    406-419 LowPass, :439-458 PrepareLaplaceKernels).
    """
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    if variance <= 1e-12:
        k = (j == 0).astype(np.float64)
    else:
        k = np.exp(-(j * j) / (2.0 * variance))
    k = k / k.sum()
    return k.astype(np.float32)


def _sep_conv(img, taps_row, taps_col):
    """Separable filtering of [C, H, W] with per-channel taps.

    taps_row/taps_col: [C, K] applied along W and H respectively, with
    edge-clamped boundaries.
    """
    C, H, W = img.shape
    K = taps_row.shape[-1]
    r = K // 2
    hi = BLUR_PRECISION
    x = jnp.pad(img, ((0, 0), (0, 0), (r, r)), mode="edge")
    # Depthwise conv along W: NCHW with feature_group_count=C
    x = jax.lax.conv_general_dilated(
        x[None],                       # [1, C, H, W+2r]
        taps_row[:, None, None, :],    # [C, 1, 1, K]
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C,
        precision=hi,
    )[0]
    x = jnp.pad(x, ((0, 0), (r, r), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None],
        taps_col[:, None, :, None],    # [C, 1, K, 1]
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C,
        precision=hi,
    )[0]
    return x


def blur(img, taps):
    """Separable Gaussian blur of [H, W] with 1-D taps (jnp or np)."""
    taps = jnp.asarray(taps)
    return _sep_conv(img[None], taps[None], taps[None])[0]


def blur_bank(img, taps_bank):
    """Blur [H, W] with a bank of B kernels at once -> [B, H, W].

    The reference computes 8 blur scales of the octave base in one
    kernel (LaplaceMultiMem); here the bank is one grouped XLA conv.
    """
    taps_bank = jnp.asarray(taps_bank)  # [B, K]
    B = taps_bank.shape[0]
    rep = jnp.broadcast_to(img[None], (B,) + img.shape)
    return _sep_conv(rep, taps_bank, taps_bank)


def scale_down(img, variance: float = 0.5):
    """5-tap Gaussian blur + 2x decimation (reference ScaleDown,
    CudaSift/cudaSiftD.cu:84-168; taps from cudaSiftH.cu:315-325)."""
    taps = jnp.asarray(gaussian_kernel(2, variance))
    out = _sep_conv(img[None], taps[None], taps[None])[0]
    return out[0::2, 0::2]


def scale_up(img):
    """2x upsample with the reference's EXACT interleave semantics
    (reference ScaleUp, cudaSiftD.cu:170-190): out[2y, 2x] = v[y, x],
    odd rows/cols are clamped midpoints.  Not
    jax.image.resize(method="linear"), whose half-pixel-center
    convention shifts the whole grid by 0.25 px relative to the
    reference (out[2y, 2x] = 0.75 v[y] + 0.25 v[y-1]) — detection
    coordinates on up-scaled configs were systematically offset.
    Pure interleave ops: no gathers, no resize lowering.
    """
    vr = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    vd = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    vdr = jnp.concatenate([vd[:, 1:], vd[:, -1:]], axis=1)
    ee = img
    eo = 0.5 * (img + vr)
    oe = 0.5 * (img + vd)
    oo = 0.25 * (img + vr + vd + vdr)
    H, W = img.shape
    rows = jnp.stack([jnp.stack([ee, eo], -1), jnp.stack([oe, oo], -1)], 1)
    return rows.reshape(2 * H, 2 * W)


def bilinear_sample(img, x, y):
    """Bilinear sample [H, W] image at float coords (x, y), clamped.

    Coordinates follow pixel-center convention: (x, y) = (col, row) of
    the sample point; integer coords hit pixel centers exactly.  This is
    the equivalent of the reference's clamp-mode linear texture
    fetches (reference CudaSift/cudaSiftH.cu:186-205) — note tex2D there
    carries a built-in half-texel offset the callers compensate for.
    """
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.0)
    y = jnp.clip(y, 0.0, H - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
