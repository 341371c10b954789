"""f32 matmul precision for the geometry compute path.

On an NVIDIA GPU, XLA may run an f32 matrix product on the tensor cores
in TF32 (10-bit mantissa, ~3 decimal digits) unless the precision asks
for more — even the dim-3 einsum contractions of the geometry code
(epipolar residual line stacks, pose candidate products, Gram builds).
Geometry residuals are small differences of O(1) products: at ~1e-3
relative error the epipolar residuals are noise against the RANSAC
inlier gate of 3e-6.

The fix is structural, not per-call-site: every jitted geometry entry
point is wrapped so that ALL matmuls traced under it default to true
f32 ("float32" — for 3x3-contraction shapes the cost is negligible).
Explicit per-op precisions (the pyramid's BLUR_PRECISION, the
matcher's score product) are unaffected.

No reference counterpart: the reference computes geometry in CUDA f32
on the CUDA cores throughout (SfM/sfm.cu); this module keeps that
guarantee under XLA.
"""

from __future__ import annotations

import functools

import jax


def f32_matmul(fn):
    """Decorator: run fn (tracing or eager) under f32 matmul default."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
