"""Vectorized 8-point RANSAC over a hypothesis bank.

Replacement for the reference's ``estimateE``
(reference SfM/sfm.cu:94-153): the reference shuffles indices on the
HOST (std::mt19937, SfM/sfm.cu:96-106), launches a per-batch transpose
loop, and materializes O(N*R) scoring intermediates (SfM/sfm.cu:163-196).

Here the whole bank runs on device under one jit:
  * sampling via the JAX counter-based PRNG (deterministic, seedable);
  * all hypotheses solved in one batched Gram eigensolve;
  * scoring chunked over the bank with ``lax.map`` so peak memory is
    O(chunk * N) while the inlier counts are the only live output;
  * winner by ``argmax`` on device (the reference's thrust::max_element
    D->H readback + off-by-one at SfM/sfm.cu:135-140 disappears);
  * optional all-inlier least-squares refit (LO-RANSAC style polish,
    absent in the reference).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.geometry import epipolar
from sfm_jax.utils.precision import f32_matmul


class RansacResult(NamedTuple):
    E: jax.Array          # [3, 3] best essential matrix
    inliers: jax.Array    # [N] bool mask
    num_inliers: jax.Array  # [] int32
    best_index: jax.Array   # [] index into the hypothesis bank
    counts: jax.Array     # [R] per-hypothesis inlier counts
    topk_E: jax.Array     # [K, 3, 3] top-K bank hypotheses by count


def sample_minimal_sets(key, mask, n_hyps: int, k: int = 8):
    """Sample [n_hyps, k] DISTINCT indices of valid correspondences.

    Valid indices are compacted to the front (stable sort on ~mask) and
    k distinct positions among the first n_valid are drawn per
    hypothesis with Floyd's algorithm (uniform without replacement, k
    fixed iterations, vectorized over the bank) — duplicate indices
    inside a minimal set would make the 8x9 system rank-deficient and
    silently waste the hypothesis slot.
    """
    from sfm_jax.ops.compact import compaction_order

    order = compaction_order(mask)  # valid indices first
    n_valid = jnp.maximum(jnp.sum(mask).astype(jnp.int32), k)
    keys = jax.random.split(key, k)
    sel = jnp.zeros((n_hyps, k), jnp.int32)
    for m in range(k):
        j = n_valid - k + m  # draw t uniform in [0, j]
        t = jax.random.randint(keys[m], (n_hyps,), 0, j + 1)
        dup = jnp.any(sel[:, :m] == t[:, None], axis=1) if m else jnp.zeros(
            (n_hyps,), bool
        )
        sel = sel.at[:, m].set(jnp.where(dup, j, t))
    return order[sel]


def _count_chunk(E_chunk, x1, x2, mask, threshold):
    r = epipolar.epipolar_residuals(E_chunk, x1, x2)  # [C, N]
    return jnp.sum((r < threshold) & mask[None, :], axis=-1).astype(jnp.int32)


@f32_matmul
def build_hypothesis_bank(key, x1, x2, mask, *, n_hyps: int, sweeps: int = 10):
    """Sample minimal sets and solve the whole 8-point bank at once.

    Shared by the estimator and the debug/parity dump (utils.debug):
    same key -> bit-identical bank.  Returns (E_bank [R,3,3],
    idx [R,8], A [R,8,9], T1, T2).
    """
    T1 = epipolar.normalizing_transform(x1, mask)
    T2 = epipolar.normalizing_transform(x2, mask)
    x1n = x1 @ T1.T
    x2n = x2 @ T2.T
    idx = sample_minimal_sets(key, mask, n_hyps)  # [R, 8]
    A = epipolar.eight_point_matrix(x1n[idx], x2n[idx])
    e = linalg.qr_nullvec(A)
    E_hat = e.reshape(-1, 3, 3)
    E_bank = linalg.project_to_essential(
        epipolar.denormalize_E(E_hat, T1, T2), sweeps=sweeps
    )
    return E_bank, idx, A, T1, T2


@functools.partial(
    jax.jit,
    static_argnames=("n_hyps", "chunk", "sweeps", "refit_iters", "topk"),
)
@f32_matmul
def ransac_essential(
    key,
    x1,
    x2,
    mask=None,
    *,
    n_hyps: int = 2048,
    threshold: float = 1e-6,
    chunk: int = 256,
    sweeps: int = 10,
    refit_iters: int = 2,
    topk: int = 16,
) -> RansacResult:
    """Estimate E from [N, 3] normalized correspondences.

    Args:
      key: PRNG key (reference uses a nondeterministic host RNG,
        SfM/sfm.cu:102-103; we are reproducible by construction).
      mask: optional [N] validity mask over correspondences.
      n_hyps: hypothesis bank size (reference: floor(N/8), SfM/sfm.cu:95).
      threshold: inlier threshold on symmetric squared epipolar distance
        in normalized coords (reference: 1e-6 algebraic, SfM/sfm.cu:220).
      chunk: hypotheses scored per lax.map step (memory = chunk * N).
      refit_iters: all-inlier least-squares polish rounds (0 disables).
      topk: top-K bank hypotheses (by inlier count) returned in
        topk_E for multi-start refinement (two_view_geometry): the
        single best draw's basin is NOT the global one on a fraction
        of seeds.
    """
    n = x1.shape[0]
    if mask is None:
        mask = jnp.ones((n,), dtype=bool)

    # Hartley-normalize once globally: all hypotheses share T1/T2, and
    # estimated matrices are denormalized before essential projection.
    # Shared with the debug/parity dump (utils.debug) so the dumped bank
    # is bit-identical to the production one.
    E_bank, _, _, T1, T2 = build_hypothesis_bank(
        key, x1, x2, mask, n_hyps=n_hyps, sweeps=sweeps
    )
    x1n = x1 @ T1.T
    x2n = x2 @ T2.T

    n_chunks = -(-n_hyps // chunk)
    pad = n_chunks * chunk - n_hyps
    E_pad = jnp.concatenate(
        [E_bank, jnp.broadcast_to(jnp.eye(3, dtype=E_bank.dtype), (pad, 3, 3))]
    ) if pad else E_bank
    counts = jax.lax.map(
        lambda Ec: _count_chunk(Ec, x1, x2, mask, threshold),
        E_pad.reshape(n_chunks, chunk, 3, 3),
    ).reshape(-1)[:n_hyps]

    best = jnp.argmax(counts)
    E = E_bank[best]

    A_all = epipolar.eight_point_matrix(x1n, x2n)  # [N, 9]
    r = epipolar.epipolar_residuals(E, x1, x2)

    def polish(carry, _):
        # Residuals ride the carry: recomputing them for the incumbent
        # E every iteration (and once more after the scan) doubled the
        # serialized residual evaluations for bit-identical results.
        E, r = carry
        w = ((r < threshold) & mask).astype(x1.dtype)
        G = jnp.einsum("ni,n,nj->ij", A_all, w, A_all)
        e = linalg.smallest_eigvec_power(G)
        E_new = linalg.project_to_essential(
            epipolar.denormalize_E(e.reshape(3, 3), T1, T2), sweeps=sweeps
        )
        # Keep the refit only if it does not lose inliers.
        c_old = jnp.sum(w).astype(jnp.int32)
        r_new = epipolar.epipolar_residuals(E_new, x1, x2)
        c_new = jnp.sum((r_new < threshold) & mask).astype(jnp.int32)
        take = c_new >= c_old
        return (jnp.where(take, E_new, E), jnp.where(take, r_new, r)), None

    if refit_iters:
        (E, r), _ = jax.lax.scan(polish, (E, r), None, length=refit_iters)

    inl = (r < threshold) & mask
    _, top_idx = jax.lax.top_k(counts, max(min(topk, n_hyps), 1))
    return RansacResult(
        E=E,
        inliers=inl,
        num_inliers=jnp.sum(inl).astype(jnp.int32),
        best_index=best,
        counts=counts,
        topk_E=E_bank[top_idx],
    )
