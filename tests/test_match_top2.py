"""The running top-2 matcher (sift.match) against a float64 numpy
top-2: blocks that do not divide N, masked columns, both score
products, exact ties, and the exact merge of per-part candidates that
the sharded matcher uses.  chip_smoke.py repeats the comparison on the
GPU at 5120^2 and 16384^2."""

import numpy as np
import jax.numpy as jnp
import pytest

from sfm_jax.config import MatchConfig
from sfm_jax.sift import match as match_mod


def _unit(rng, n):
    d = rng.normal(size=(n, 128))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _np_top2(d1, d2, valid2):
    """float64 reference: (best, second, index), ties -> lowest index."""
    S = d1.astype(np.float64) @ d2.astype(np.float64).T
    S[:, ~valid2] = -2.0
    idx = S.argmax(1)
    rows = np.arange(len(S))
    best = S[rows, idx]
    S[rows, idx] = -2.0
    return best, S.max(1), idx


@pytest.mark.parametrize(
    "n1,n2,chunk,bf16",
    [
        (37, 300, 64, False),     # N2 not a multiple of the chunk
        (64, 256, 256, False),    # one chunk
        (70, 517, 32, False),     # many chunks, ragged last one
        (50, 333, 128, True),     # bf16 operands, f32 accumulation
    ],
)
def test_top2_matches_numpy(rng, n1, n2, chunk, bf16):
    d1, d2 = _unit(rng, n1), _unit(rng, n2)
    v2 = rng.random(n2) > 0.25                      # masked columns
    b, s, i = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), chunk=chunk,
        bf16=bf16)
    rb, rs, ri = _np_top2(d1, d2, v2)
    tol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose(np.array(b), rb, atol=tol)
    np.testing.assert_allclose(np.array(s), rs, atol=tol)
    clear = (rb - rs) > tol
    np.testing.assert_array_equal(np.array(i)[clear], ri[clear])
    assert v2[np.array(i)].all()   # winners always land on valid points


def test_top2_exact_ties_keep_lowest_index(rng):
    # Every right descriptor appears twice, in different chunks: best
    # equals second and the index is the first copy.
    d1 = _unit(rng, 24)
    base = _unit(rng, 40)
    d2 = np.concatenate([base, base])
    b, s, i = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), chunk=16)
    _, _, ri = _np_top2(d1, base, np.ones(40, bool))
    np.testing.assert_array_equal(np.array(i), ri)
    np.testing.assert_array_equal(np.array(b), np.array(s))


def test_merge_top2_equals_global_top2(rng):
    # Splitting N2 into parts and merging is exact.
    d1, d2 = _unit(rng, 20), _unit(rng, 96)
    parts = [match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2[k:k + 32])) for k in range(0, 96, 32)]
    best = jnp.stack([p[0] for p in parts])
    second = jnp.stack([p[1] for p in parts])
    idx = jnp.stack([p[2] + 32 * k for k, p in enumerate(parts)])
    gb, gs, gi = match_mod.merge_top2(best, second, idx)
    rb, rs, ri = _np_top2(d1, d2, np.ones(96, bool))
    np.testing.assert_array_equal(np.array(gi), ri)
    np.testing.assert_allclose(np.array(gb), rb, atol=1e-5)
    np.testing.assert_allclose(np.array(gs), rs, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_match_honours_the_score_product(rng, bf16):
    # match() computes the product MatchConfig.bf16 names.
    d1, d2 = _unit(rng, 40), _unit(rng, 90)
    m = match_mod.match(jnp.asarray(d1), jnp.asarray(d2),
                        cfg=MatchConfig(bf16=bf16))
    b, _, i = match_mod.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), bf16=bf16)
    np.testing.assert_array_equal(np.array(m.index), np.array(i))
    np.testing.assert_array_equal(np.array(m.score), np.array(b))
