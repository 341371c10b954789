"""Brute-force descriptor matching with running top-2 + ratio test.

Replacement for MatchSiftData / FindMaxCorr10 (reference
CudaSift/matching.cu:1090-1206, 289-397): the N1 x N2 x 128 correlation
is a matrix product, scanned over N2 tiles with a running (best,
second-best, index) carry so the full score matrix is never
materialized — only one [N1, chunk] tile per step.

Contract parity (matching.cu:381-396): per left point — match index =
argmax correlation, score = best correlation, ambiguity = second_best /
(best + 1e-6) where second-best excludes the best index.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.config import MatchConfig


class Matches(NamedTuple):
    index: jnp.ndarray      # [N1] int32 best match in set 2
    score: jnp.ndarray      # [N1] best correlation
    ambiguity: jnp.ndarray  # [N1] second_best / best
    valid: jnp.ndarray      # [N1] passes masks + thresholds


_NEG = -2.0  # correlations of unit vectors are in [-1, 1]


@functools.partial(jax.jit, static_argnames=("chunk", "bf16"))
def match_descriptors_top2(desc1, desc2, valid2=None, *, chunk: int = 2048,
                           bf16: bool = False):
    """Running top-2 correlation of [N1,128] vs [N2,128].

    Returns (best, second, index).  Invalid right-side points are
    excluded via `valid2`.  bf16: bf16 operands with f32 accumulation;
    otherwise f32 operands at HIGHEST precision (no TF32).
    """
    n1 = desc1.shape[0]
    n2 = desc2.shape[0]
    if valid2 is None:
        valid2 = jnp.ones((n2,), bool)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    desc1, desc2 = desc1.astype(dt), desc2.astype(dt)
    prec = (jax.lax.Precision.DEFAULT if bf16
            else jax.lax.Precision.HIGHEST)
    n_chunks = -(-n2 // chunk)
    pad = n_chunks * chunk - n2
    d2 = jnp.pad(desc2, ((0, pad), (0, 0)))
    v2 = jnp.pad(valid2, (0, pad))
    d2 = d2.reshape(n_chunks, chunk, -1)
    v2 = v2.reshape(n_chunks, chunk)
    base = jnp.arange(chunk, dtype=jnp.int32)

    def step(carry, inp):
        best, second, bidx = carry
        d2c, v2c, off = inp
        scores = jnp.dot(
            desc1, d2c.T, preferred_element_type=jnp.float32, precision=prec
        )  # [N1, chunk]
        scores = jnp.where(v2c[None, :], scores, _NEG)
        loc_best = jnp.max(scores, axis=1)
        loc_arg = jnp.argmax(scores, axis=1).astype(jnp.int32)
        masked = jnp.where(base[None, :] == loc_arg[:, None], _NEG, scores)
        loc_second = jnp.max(masked, axis=1)
        loc_idx = loc_arg + off
        # Merge local top2 into carry.
        new_best = jnp.maximum(best, loc_best)
        take_loc = loc_best > best
        new_idx = jnp.where(take_loc, loc_idx, bidx)
        new_second = jnp.where(
            take_loc,
            jnp.maximum(best, loc_second),
            jnp.maximum(second, loc_best),
        )
        return (new_best, new_second, new_idx), None

    # Carry stays f32 regardless of descriptor dtype (scores accumulate
    # in f32 via preferred_element_type).
    init = (
        jnp.full((n1,), _NEG, jnp.float32),
        jnp.full((n1,), _NEG, jnp.float32),
        jnp.zeros((n1,), jnp.int32),
    )
    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best, second, idx), _ = jax.lax.scan(step, init, (d2, v2, offsets))
    return best, second, idx


def merge_top2(best, second, idx):
    """Exact top-2 merge of [S, N] per-part candidates -> [N] each.

    The global second is the larger of the winning part's second and
    the best of any other part; ties go to the lowest part index (so
    parts in column order keep the lowest column on exact ties)."""
    s_iota = jnp.arange(best.shape[0], dtype=jnp.int32)[:, None]
    g_best = jnp.max(best, axis=0)
    g_arg = jnp.min(
        jnp.where(best == g_best[None, :], s_iota, jnp.int32(2 ** 30)), axis=0
    )
    at = s_iota == g_arg[None, :]
    runner = jnp.max(jnp.where(at, _NEG, best), axis=0)
    sec_at = jnp.max(jnp.where(at, second, _NEG), axis=0)
    g_idx = jnp.max(jnp.where(at, idx, -1), axis=0)
    return g_best, jnp.maximum(runner, sec_at), g_idx


@functools.partial(jax.jit, static_argnames=("cfg", "chunk"))
def match(desc1, desc2, valid1=None, valid2=None,
          cfg: MatchConfig = MatchConfig(), *, chunk: int = 2048) -> Matches:
    n1 = desc1.shape[0]
    if valid1 is None:
        valid1 = jnp.ones((n1,), bool)
    best, second, idx = match_descriptors_top2(desc1, desc2, valid2,
                                               chunk=chunk, bf16=cfg.bf16)
    ambiguity = second / (best + 1e-6)
    ok = valid1 & (best > cfg.min_score) & (ambiguity < cfg.max_ambiguity)
    if cfg.mutual:
        _, _, ridx = match_descriptors_top2(desc2, desc1, valid1,
                                            chunk=chunk, bf16=cfg.bf16)
        ok = ok & (ridx[idx] == jnp.arange(n1, dtype=jnp.int32))
    return Matches(index=idx, score=best, ambiguity=ambiguity, valid=ok)
