"""Eight-point essential-matrix estimation and epipolar residuals.

Replacement for the reference's RANSAC inner machinery:
  * per-hypothesis 8x9 Kronecker system (reference SfM/kernels.h:236-259)
  * batched 8x9 SVD null vector (reference SfM/kernels.h:211-234, 452-458)
  * essential projection (reference SfM/kernels.h:281-295)
  * inlier scoring (reference SfM/sfm.cu:155-236)

Everything is expressed as dense batched einsums + the fixed-sweep Jacobi
eigensolver in :mod:`sfm_jax.ops.linalg` — no per-batch host loops, no
cuSOLVER handles.  The reference's scoring had two real bugs we do NOT
replicate (``norm_d2`` never computed, SfM/sfm.cu:211-212; best-index
off-by-one, SfM/sfm.cu:137): we use the standard symmetric squared
epipolar distance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.utils.precision import f32_matmul


def eight_point_matrix(x1, x2):
    """Build the [..., n, 9] constraint matrix for x2^T E x1 = 0.

    Args:
      x1, x2: [..., n, 3] normalized homogeneous correspondences.

    Row i is kron(x2_i, x1_i), i.e. A[i, 3j+k] = x2_i[j] * x1_i[k] with E
    flattened row-major (reference SfM/kernels.h:236-259 builds the same
    system, one CUDA thread per hypothesis).
    """
    A = x2[..., :, None] * x1[..., None, :]  # [..., n, 3, 3]
    return A.reshape(*A.shape[:-2], 9)


@functools.partial(jax.jit, static_argnames=("sweeps",))
def estimate_E_8pt(x1, x2, *, sweeps: int = 10):
    """Batched 8-point essential estimate from [..., 8, 3] minimal sets.

    Returns [..., 3, 3] essential matrices projected to singular values
    (1, 1, 0).
    """
    A = eight_point_matrix(x1, x2)
    e = linalg.qr_nullvec(A)  # [..., 9]
    E = e.reshape(*e.shape[:-1], 3, 3)
    return linalg.project_to_essential(E, sweeps=sweeps)


@f32_matmul
def normalizing_transform(x, mask=None):
    """Hartley isotropic normalization transform for [N, 3] points.

    Returns T [3, 3] such that x' = x @ T.T has zero centroid and mean
    radius sqrt(2) over the masked points.  The reference skips this and
    pays for it in f32 conditioning (its 8-point systems feed a Jacobi
    SVD at tol 1e-7, SfM/sfm.cu:50-52, with no column balancing).
    """
    xy = x[..., :2] / x[..., 2:3]
    if mask is None:
        w = jnp.ones(xy.shape[:-1], dtype=x.dtype)
    else:
        w = mask.astype(x.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    c = jnp.sum(xy * w[..., None], axis=-2) / wsum
    d = jnp.sqrt(jnp.sum((xy - c[..., None, :]) ** 2, axis=-1))
    mean_d = jnp.sum(d * w, axis=-1) / wsum[..., 0]
    # Floor keeps the scale bounded for degenerate (coincident-point)
    # inputs, where an unbounded scale overflows f32 in the Gram/QR
    # solves downstream.
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-3)
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.stack([s, zero, -s * c[..., 0]], axis=-1),
            jnp.stack([zero, s, -s * c[..., 1]], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return T


def denormalize_E(E_hat, T1, T2):
    """Map E estimated in Hartley-normalized coords back: E = T2^T Ê T1."""
    return jnp.einsum("ji,...jk,kl->...il", T2, E_hat, T1)


@f32_matmul
def epipolar_residuals(E, x1, x2):
    """Symmetric squared epipolar distance of all points vs all E.

    Args:
      E: [..., 3, 3] (any leading batch dims, e.g. the hypothesis bank).
      x1, x2: [N, 3] normalized homogeneous points.

    Returns [..., N] residuals r = (x2^T E x1)^2 * (1/||l1_xy||^2 +
    1/||l2_xy||^2).  The reference's n1/d1 + n2/d2 scoring
    (SfM/sfm.cu:155-220) is the same quantity modulo its norm_d2 bug.
    """
    l1 = jnp.einsum("...ij,nj->...ni", E, x1)  # epipolar lines in image 2
    l2 = jnp.einsum("...ji,nj->...ni", E, x2)  # lines in image 1
    num = jnp.einsum("ni,...ni->...n", x2, l1)
    num = num * num
    d1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    d2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    eps = jnp.asarray(1e-18, dtype=num.dtype)
    return num * (1.0 / (d1 + eps) + 1.0 / (d2 + eps))


@f32_matmul
def sampson_residuals(E, x1, x2):
    """First-order (Sampson) squared epipolar error, [..., N]."""
    l1 = jnp.einsum("...ij,nj->...ni", E, x1)
    l2 = jnp.einsum("...ji,nj->...ni", E, x2)
    num = jnp.einsum("ni,...ni->...n", x2, l1)
    num = num * num
    den = l1[..., 0] ** 2 + l1[..., 1] ** 2 + l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-18)
