"""Mask compaction without sorting.

`argsort(~valid)` costs a full sort (O(n log n) or worse); for a boolean
key the stable partition is just two cumsums and a scatter.  Used to
pack valid keypoints/correspondences to the front.
"""

from __future__ import annotations

import jax.numpy as jnp


def compaction_order(valid):
    """Stable permutation putting True entries first.

    Equivalent to jnp.argsort(~valid, stable=True) but O(n):
    order[j] = index of the element that lands at position j.
    """
    k = valid.shape[0]
    v = valid.astype(jnp.int32)
    n_valid = jnp.sum(v)
    pos_valid = jnp.cumsum(v) - 1
    pos_invalid = n_valid + jnp.cumsum(1 - v) - 1
    pos = jnp.where(valid, pos_valid, pos_invalid)
    return jnp.zeros((k,), jnp.int32).at[pos].set(
        jnp.arange(k, dtype=jnp.int32)
    )
