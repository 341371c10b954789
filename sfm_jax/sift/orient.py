"""Orientation assignment with dual-peak keypoint duplication.

Replacement for ComputeOrientationsCONST
(reference CudaSift/cudaSiftD.cu:972-1057): the per-keypoint 32-bin
gradient histogram is built with one-hot matmuls over a gathered 11x11
window (no shared-memory atomics), smoothing is a circular [1,4,6,4,1]
convolution via rolls, and the reference's `atomicInc` second-peak
duplication (:1041-1053) becomes a fixed second slot per keypoint with
a validity mask.

Behavioral parity:
  * gradient samples at integer offsets (-5..5) around the sub-pixel
    position, bilinear interpolation, central differences (:995-997)
  * Gaussian weight sigma = 1.5 * scale evaluated at integer offsets
    (:982-984)
  * bin = floor(16*atan2(dy,dx)/pi + 16.5) wrapped to 32 (:998-1000)
  * peak if v > left and v >= right on the smoothed histogram (:1014)
  * parabolic sub-bin interpolation, orientation in degrees (:1035-1038)
  * duplicate when second peak > 0.8 * max (:1041)
"""

from __future__ import annotations

import jax.numpy as jnp

from sfm_jax.ops.image import bilinear_sample

_N_BINS = 32


def orientation_histograms(img, x, y, scale):
    """[K, 32] gradient orientation histograms around keypoints."""
    offs = jnp.arange(11, dtype=jnp.float32) - 5.0  # [-5..5]
    px = x[:, None, None] + offs[None, None, :]
    py = y[:, None, None] + offs[None, :, None]
    dx = bilinear_sample(img, px + 1.0, py) - bilinear_sample(img, px - 1.0, py)
    dy = bilinear_sample(img, px, py + 1.0) - bilinear_sample(img, px, py - 1.0)
    grad = jnp.sqrt(dx * dx + dy * dy)
    i2s2 = 1.0 / (2.0 * (1.5 * scale) ** 2)
    g = jnp.exp(-(offs * offs)[None, :] * i2s2[:, None])  # [K, 11]
    w = grad * g[:, :, None] * g[:, None, :]
    bins = jnp.floor(16.0 * jnp.arctan2(dy, dx) / jnp.pi + 16.5).astype(jnp.int32)
    bins = jnp.where(bins > 31, 0, bins)
    onehot = (bins[..., None] == jnp.arange(_N_BINS)).astype(jnp.float32)
    return jnp.einsum("kij,kijb->kb", w, onehot)


def smooth_histogram(h):
    """Circular [1,4,6,4,1] smoothing (reference :1009-1011)."""
    return (
        6.0 * h
        + 4.0 * (jnp.roll(h, 1, axis=-1) + jnp.roll(h, -1, axis=-1))
        + jnp.roll(h, 2, axis=-1)
        + jnp.roll(h, -2, axis=-1)
    )


def _interp_peak(hs, idx):
    """Parabolic sub-bin peak refinement -> orientation in degrees."""
    K = hs.shape[0]
    rows = jnp.arange(K)
    v0 = hs[rows, idx]
    vp = hs[rows, (idx + 1) % _N_BINS]
    vm = hs[rows, (idx - 1) % _N_BINS]
    denom = 2.0 * v0 - vp - vm
    peak = idx.astype(jnp.float32) + 0.5 * (vp - vm) / jnp.where(
        jnp.abs(denom) < 1e-12, 1e-12, denom
    )
    peak = jnp.where(peak < 0.0, peak + _N_BINS, peak)
    return 11.25 * peak


def assign_orientations(img, x, y, scale, valid, *, duplicates=True):
    """Returns (orientation1 [K], orientation2 [K], valid2 [K]).

    orientation2/valid2 encode the reference's duplicated keypoints for
    strong secondary peaks.
    """
    h = orientation_histograms(img, x, y, scale)
    return orientations_from_histograms(h, valid, duplicates=duplicates)


def orientations_from_histograms(h, valid, *, duplicates=True):
    """Peak finding on [K, 32] histograms -> (ori1, ori2, valid2)."""
    hs = smooth_histogram(h)
    left = jnp.roll(hs, 1, axis=-1)
    right = jnp.roll(hs, -1, axis=-1)
    is_peak = (hs > left) & (hs >= right)
    pv = jnp.where(is_peak, hs, 0.0)
    i1 = jnp.argmax(pv, axis=-1)
    K = hs.shape[0]
    rows = jnp.arange(K)
    max1 = pv[rows, i1]
    pv2 = pv.at[rows, i1].set(0.0)
    i2 = jnp.argmax(pv2, axis=-1)
    max2 = pv2[rows, i2]
    ori1 = jnp.where(max1 > 0, _interp_peak(hs, i1), 0.0)
    ori2 = jnp.where(max2 > 0, _interp_peak(hs, i2), 0.0)
    valid2 = valid & (max2 > 0.8 * max1) & (max2 > 0)
    if not duplicates:
        valid2 = jnp.zeros_like(valid2)
    return ori1, ori2, valid2
