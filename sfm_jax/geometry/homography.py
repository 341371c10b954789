"""Vectorized 4-point homography RANSAC.

Replacement for the reference's FindHomography utility
(reference CudaSift/matching.cu:907-1087): the reference samples
4-point sets on the CPU, inverts an 8x8 system per hypothesis with a
device LU template (matching.cu:821-905), and counts inliers with
TestHomographies.  Here the whole hypothesis bank is one batched
QR null-space solve of the standard 2N x 9 DLT system plus a fused
scoring pass — no host sampling loop, no per-hypothesis kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.geometry import epipolar
from sfm_jax.utils.precision import f32_matmul


class HomographyResult(NamedTuple):
    H: jax.Array           # [3, 3]
    inliers: jax.Array     # [N] bool
    num_inliers: jax.Array


def homography_system(uv1, uv2):
    """[..., N, 2, 9] DLT rows for uv2 ~ H uv1 (inhomogeneous pairs)."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=-1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], axis=-1)
    return jnp.stack([r1, r2], axis=-2)


@f32_matmul
def transfer_errors(H, uv1, uv2):
    """[..., N] squared symmetric-free forward transfer error."""
    x = jnp.concatenate([uv1, jnp.ones_like(uv1[..., :1])], axis=-1)
    p = jnp.einsum("...ij,nj->...ni", H, x)
    w = jnp.where(jnp.abs(p[..., 2]) < 1e-12, 1e-12, p[..., 2])
    pred = p[..., :2] / w[..., None]
    return jnp.sum((pred - uv2) ** 2, axis=-1)


@functools.partial(jax.jit, static_argnames=("n_hyps", "refit_iters"))
@f32_matmul
def ransac_homography(
    key,
    uv1,
    uv2,
    mask=None,
    *,
    n_hyps: int = 1024,
    threshold: float = 9.0,   # px^2; reference default maxAmbiguity-era ~ 5 px
    refit_iters: int = 2,
) -> HomographyResult:
    """Robust homography from [N, 2] pixel correspondences."""
    n = uv1.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)

    # Hartley-normalize for conditioning.
    ones = jnp.ones((n, 1), uv1.dtype)
    h1 = jnp.concatenate([uv1, ones], axis=-1)
    h2 = jnp.concatenate([uv2, ones], axis=-1)
    T1 = epipolar.normalizing_transform(h1, mask)
    T2 = epipolar.normalizing_transform(h2, mask)
    n1 = (h1 @ T1.T)[:, :2]
    n2 = (h2 @ T2.T)[:, :2]

    from sfm_jax.geometry.ransac import sample_minimal_sets

    # Distinct indices per minimal set (Floyd sampling, shared with the
    # essential-matrix RANSAC): duplicates make the 8x9 system
    # rank-deficient and silently waste the hypothesis slot.
    idx = sample_minimal_sets(key, mask, n_hyps, k=4)

    A = homography_system(n1[idx], n2[idx]).reshape(n_hyps, 8, 9)
    hvec = linalg.qr_nullvec(A)
    Hn = hvec.reshape(n_hyps, 3, 3)
    # Denormalize: H = T2^{-1} Hn T1
    T2inv = jnp.linalg.inv(T2)
    H_bank = jnp.einsum("ij,njk,kl->nil", T2inv, Hn, T1)

    errs = transfer_errors(H_bank, uv1, uv2)  # [R, N]
    counts = jnp.sum((errs < threshold) & mask[None, :], axis=-1)
    best = jnp.argmax(counts)
    H = H_bank[best]

    A_all = homography_system(n1, n2)  # [N, 2, 9]

    def polish(H, _):
        e = transfer_errors(H, uv1, uv2)
        w = ((e < threshold) & mask).astype(uv1.dtype)
        w2 = jnp.repeat(w, 2)
        Af = A_all.reshape(-1, 9)
        G = jnp.einsum("ni,n,nj->ij", Af, w2, Af)
        # Ridge inverse iteration (see ransac.polish): the 9x9 Jacobi
        # chain is latency-bound for a single matrix.
        hv = linalg.smallest_eigvec_power(G)
        H_new = jnp.einsum("ij,jk,kl->il", T2inv, hv.reshape(3, 3), T1)
        c_old = jnp.sum(w).astype(jnp.int32)
        c_new = jnp.sum(
            (transfer_errors(H_new, uv1, uv2) < threshold) & mask
        ).astype(jnp.int32)
        return jnp.where(c_new >= c_old, H_new, H), None

    if refit_iters:
        H, _ = jax.lax.scan(polish, H, None, length=refit_iters)

    e = transfer_errors(H, uv1, uv2)
    inl = (e < threshold) & mask
    H = H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])
    return HomographyResult(
        H=H, inliers=inl, num_inliers=jnp.sum(inl).astype(jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("loops",))
@f32_matmul
def improve_homography(H, uv1, uv2, mask, *, loops: int = 5,
                       threshold: float = 9.0):
    """Iterative all-inlier homography polish — the reference's
    ImproveHomography (CudaSift/geomFuncs.cpp:6-73): `loops` rounds of
    a hard-gated (err < threshold px^2) weighted DLT refit over the
    `mask` candidates, applied UNCONDITIONALLY each round (the
    reference has no acceptance check).  The reference solves the
    inhomogeneous 8-parameter normal equations; the normalized DLT
    null-space used here is the same least-squares geometry with
    better conditioning.
    """
    n = uv1.shape[0]
    ones = jnp.ones((n, 1), uv1.dtype)
    h1 = jnp.concatenate([uv1, ones], axis=-1)
    h2 = jnp.concatenate([uv2, ones], axis=-1)
    T1 = epipolar.normalizing_transform(h1, mask)
    T2 = epipolar.normalizing_transform(h2, mask)
    n1 = (h1 @ T1.T)[:, :2]
    n2 = (h2 @ T2.T)[:, :2]
    T2inv = jnp.linalg.inv(T2)
    A_all = homography_system(n1, n2).reshape(-1, 9)  # [2N, 9]

    def loop(H, _):
        e = transfer_errors(H, uv1, uv2)
        w = jnp.repeat(((e < threshold) & mask).astype(uv1.dtype), 2)
        G = jnp.einsum("ni,n,nj->ij", A_all, w, A_all)
        hv = linalg.smallest_eigvec_power(G)
        H_new = jnp.einsum("ij,jk,kl->il", T2inv, hv.reshape(3, 3), T1)
        return H_new, None

    H, _ = jax.lax.scan(loop, H, None, length=loops)
    return H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])
