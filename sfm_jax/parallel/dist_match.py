"""Sharded pairwise descriptor matching across the device mesh.

NO reference counterpart (single-GPU matcher,
reference CudaSift/matching.cu).  Strategy: replicate the left
descriptor set, shard the right set over devices; each device runs the
running-top-2 matcher against its shard; the global top-2 merge is an
all_gather of the tiny [N1]-sized candidate tuples followed by a
branchless merge — O(D * N1) bytes over the interconnect vs
O(N1 * N2) compute kept local.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sfm_jax.config import MatchConfig
from sfm_jax.sift.match import Matches, match_descriptors_top2, merge_top2
from sfm_jax.parallel.mesh import DATA_AXIS


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "chunk", "axis", "bf16"),
)
def dist_match_top2(desc1, desc2_sh, valid2_sh, mesh: Mesh, *,
                    chunk: int = 2048, axis: str = DATA_AXIS,
                    bf16: bool = False):
    """Distributed top-2 matching.

    Args:
      desc1: [N1, 128] replicated.
      desc2_sh: [N2, 128] sharded on the leading dim (N2 divisible by
        the mesh size; pad + mask otherwise).
      valid2_sh: [N2] sharded validity.
      bf16: score product, as in sift.match.match_descriptors_top2.

    Returns replicated (best, second, index) with global indices.
    """
    # Global indices ride the all_gather as float32 alongside the
    # scores (one [D, N1, 3] gather instead of two); f32 represents
    # integers exactly only up to 2^24, so the global N2 must stay
    # under it.  16.7M descriptors ~ 8.6 GB — far beyond
    # any per-pair capacity here, but guard it statically.
    assert desc2_sh.shape[0] < (1 << 24), (
        "dist_match merges indices through float32; global N2 >= 2^24 "
        "would corrupt them — gather indices separately at this scale"
    )

    def body(d1, d2_loc, v2_loc):
        n2_loc = d2_loc.shape[0]
        me = jax.lax.axis_index(axis)
        best, second, idx = match_descriptors_top2(
            d1, d2_loc, v2_loc, chunk=min(chunk, n2_loc), bf16=bf16,
        )
        idx = idx + me * n2_loc  # globalize
        # Gather all devices' candidates and merge: O(D * N1 * 12 B)
        # over the interconnect.  merge_top2 is exact because each
        # device's (best, second) are its true local top-2.
        cands = jax.lax.all_gather(
            jnp.stack([best, second, idx.astype(jnp.float32)], axis=-1),
            axis,
        )  # [D, N1, 3]
        return merge_top2(
            cands[..., 0], cands[..., 1], cands[..., 2].astype(jnp.int32)
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(desc1, desc2_sh, valid2_sh)


@functools.partial(jax.jit, static_argnames=("mesh", "cfg", "chunk", "axis"))
def dist_match(desc1, desc2, valid1=None, valid2=None,
               cfg: MatchConfig = MatchConfig(), *, mesh: Mesh,
               chunk: int = 2048, axis: str = DATA_AXIS) -> Matches:
    """Mesh-sharded drop-in for sift.match.match (same Matches contract:
    ratio test, score threshold).  N2 must divide by the mesh size —
    the fixed keypoint capacities are chosen to (frontend capacity =
    num_octaves * 2 * max_pts_per_octave, a multiple of typical mesh
    sizes); otherwise pad + mask desc2 before calling.
    """
    n1 = desc1.shape[0]
    if valid1 is None:
        valid1 = jnp.ones((n1,), bool)
    if valid2 is None:
        valid2 = jnp.ones((desc2.shape[0],), bool)
    best, second, idx = dist_match_top2(
        desc1, desc2, valid2, mesh, chunk=chunk, axis=axis,
        bf16=cfg.bf16,
    )
    ambiguity = second / (best + 1e-6)
    ok = valid1 & (best > cfg.min_score) & (ambiguity < cfg.max_ambiguity)
    return Matches(index=idx, score=best, ambiguity=ambiguity, valid=ok)
