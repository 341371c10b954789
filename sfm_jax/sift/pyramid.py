"""Gaussian scale-space / DoG pyramid.

Equivalent of the reference's pyramid machinery:
  * LowPass prefilter (reference CudaSift/cudaSiftH.cu:406-435,
    cudaSiftD.cu:1986-2037)
  * per-octave 8-scale blur bank + adjacent differences
    (reference LaplaceMultiMem, cudaSiftD.cu:1753-1793, kernels from
    PrepareLaplaceKernels, cudaSiftH.cu:439-458)
  * ScaleDown octave descent (cudaSiftH.cu:146-167, cudaSiftD.cu:84-168)

Semantics reproduced exactly: blur sigma of plane i (i = 0..S+2) is
sqrt(max(2^(2(i-1)/S) - b_o^2, 0)) where b_o is the accumulated octave
base blur (0 at full resolution, then b' = sqrt(b^2 + 0.25)/2 per
octave), kernels are truncated at radius 4 and renormalized, and DoG
plane j = blur[j+1] - blur[j] (7 planes).  All 8 blurs of an octave run
as one grouped conv; octaves have static shapes so the whole pyramid
jits into a single XLA program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sfm_jax.config import SiftConfig
from sfm_jax.ops import image as imops


class Octave(NamedTuple):
    base: jnp.ndarray   # [H, W] octave base image (for gradients)
    dog: jnp.ndarray    # [S+2, H, W] difference-of-Gaussian planes
    subsampling: float  # coordinate scale back to input pixels


def octave_base_blurs(num_octaves: int) -> list:
    """Accumulated base blur per octave, index 0 = full resolution.

    Reference recursion: b_{k+1} = sqrt(b_k^2 + 0.5^2) / 2 with b_0 = 0
    (PrepareLaplaceKernels called with initBlur=0, cudaSiftH.cu:110;
    recursion at :441-443, ExtractSiftLoop :158).
    """
    blurs = [0.0]
    for _ in range(num_octaves - 1):
        b = blurs[-1]
        blurs.append(math.sqrt(b * b + 0.25) / 2.0)
    return blurs


def octave_kernel_bank(cfg: SiftConfig, octave_index: int) -> np.ndarray:
    """[S+3, 2r+1] blur taps for one octave (host-side constants)."""
    S = cfg.num_scales
    base_blur = octave_base_blurs(cfg.num_octaves)[octave_index]
    taps = []
    for i in range(S + 3):
        scale = 2.0 ** ((i - 1) / S)
        var = scale * scale - base_blur * base_blur
        taps.append(imops.gaussian_kernel(cfg.laplace_radius, max(var, 0.0)))
    return np.stack(taps)


def lowpass(img, cfg: SiftConfig):
    """Prefilter with sigma = init_blur (reference LowPass semantics:
    kernel exp(-j^2/(2*scale^2)) with scale = initBlur,
    cudaSiftH.cu:409-417)."""
    sigma = max(cfg.init_blur, 1e-3)
    taps = imops.gaussian_kernel(cfg.lowpass_radius, sigma * sigma)
    return imops.blur(img, taps)


def build_octave(base, cfg: SiftConfig, octave_index: int,
                 subsampling: float) -> Octave:
    bank = octave_kernel_bank(cfg, octave_index)
    blurred = imops.blur_bank(base, bank)        # [S+3, H, W]
    dog = blurred[1:] - blurred[:-1]             # [S+2, H, W]
    # Force materialization: without the barrier XLA may fuse the blur
    # bank into every one of the detector's ~14 shifted reads of the
    # DoG volume, recomputing the convolutions each time.
    base, dog = jax.lax.optimization_barrier((base, dog))
    return Octave(base=base, dog=dog, subsampling=subsampling)


def build_pyramid(img, cfg: SiftConfig) -> list:
    """Full pyramid: list of Octave, finest (subsampling=1) first.

    The reference processes coarsest-first due to its recursion order
    (ExtractSiftLoop), but order is irrelevant for the set of outputs.
    """
    if cfg.up_scale:
        img = imops.scale_up(img)
    base = lowpass(img, cfg)
    octaves = []
    sub = 1.0
    for o in range(cfg.num_octaves):
        octaves.append(build_octave(base, cfg, o, sub))
        if o + 1 < cfg.num_octaves:
            base = imops.scale_down(base, 0.5)
            sub *= 2.0
    return octaves
