"""SIFT frontend orchestration: pyramid -> detect -> orient -> describe.

Equivalent of the reference's ExtractSift host loop
(reference CudaSift/cudaSiftH.cu:72-167).  Architecture:

  * detection runs densely per octave (static shapes);
  * all octave base images are packed into ONE vertical atlas with
    edge-replicated guard bands, so orientation and descriptor
    sampling for EVERY keypoint of every octave run as one batched
    gather over the atlas each;
  * keypoints are globally compacted by validity so sampling work
    scales with the real keypoint count, not the slot capacity;
  * the global SiftPoint array + device counters of the reference
    become fixed-capacity SoA arrays with validity masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sfm_jax.config import SiftConfig
from sfm_jax.ops.compact import compaction_order
from sfm_jax.sift import pyramid, detect as detect_mod, orient, describe

_GUARD = 48  # vertical guard rows between octaves (>= descriptor patch)


class Keypoints(NamedTuple):
    """SoA keypoint set (replaces the reference's AoS SiftPoint,
    CudaSift/cudaSift.h:6-22).  Coordinates are in input-image pixels."""

    x: jnp.ndarray            # [K]
    y: jnp.ndarray            # [K]
    scale: jnp.ndarray        # [K]
    sharpness: jnp.ndarray    # [K]
    edgeness: jnp.ndarray     # [K]
    orientation: jnp.ndarray  # [K] degrees
    octave: jnp.ndarray       # [K] int32
    valid: jnp.ndarray        # [K] bool

    @property
    def capacity(self):
        return self.x.shape[0]

    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


class SiftResult(NamedTuple):
    keypoints: Keypoints
    descriptors: jnp.ndarray  # [K, 128]


def _build_atlas(bases):
    """Pack octave base images vertically with edge-replicated guards.

    Returns (atlas [Ha, W0], row_offsets list).  Guards prevent a
    patch at one octave's border from reading another octave's pixels;
    horizontal padding replicates each octave's right edge.
    """
    W0 = bases[0].shape[1]
    rows = []
    offsets = []
    y = 0
    for base in bases:
        H, W = base.shape
        padded = jnp.pad(
            base, ((_GUARD, _GUARD), (0, W0 - W)), mode="edge"
        )
        offsets.append(y + _GUARD)
        rows.append(padded)
        y += H + 2 * _GUARD
    atlas = jnp.concatenate(rows, axis=0)
    # Materialize the atlas once instead of letting XLA fuse the pad /
    # concat chain into the sampling kernels' input.
    atlas = jax.lax.optimization_barrier(atlas)
    return atlas, offsets


def atlas_layout(shape, cfg: SiftConfig):
    """Static atlas layout for an input of `shape`: (offsets, subs)."""
    H, W = shape
    if cfg.up_scale:
        H, W = 2 * H, 2 * W
    offsets = []
    subs = []
    y = 0
    sub = 1.0
    for _ in range(cfg.num_octaves):
        offsets.append(y + _GUARD)
        subs.append(sub)
        y += H + 2 * _GUARD
        H, W = H // 2, W // 2
        sub *= 2.0
    return tuple(offsets), tuple(subs)


def _octave_cfg(cfg: SiftConfig, o: int) -> SiftConfig:
    """Per-octave detection config: applies cfg.octave_caps[o] as the
    slot cap when set (detection counts fall ~2x per octave; a uniform
    cap makes deep octaves pay top-k/gather/sample cost for slots they
    never fill — SiftConfig.octave_caps)."""
    if cfg.octave_caps is None:
        return cfg
    if len(cfg.octave_caps) != cfg.num_octaves:
        raise ValueError(
            f"octave_caps must have num_octaves={cfg.num_octaves} "
            f"entries; got {len(cfg.octave_caps)}"
        )
    import dataclasses

    return dataclasses.replace(
        cfg, max_pts_per_octave=int(cfg.octave_caps[o])
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _detect_stage(img, cfg: SiftConfig):
    """Dense stage: pyramid + per-octave NMS + atlas, one XLA program.
    Detections are shifted into atlas-frame coordinates for the shared
    sampling stage."""
    octaves = pyramid.build_pyramid(img, cfg)
    atlas, offsets = _build_atlas([o.base for o in octaves])
    dets = []
    for o, (oct_, off) in enumerate(zip(octaves, offsets)):
        d = detect_mod.detect(oct_.dog, _octave_cfg(cfg, o),
                              oct_.subsampling)
        dets.append(d._replace(y=d.y + off))
    return atlas, dets


def extract_sift(img, cfg: SiftConfig = SiftConfig()) -> SiftResult:
    """Full SIFT extraction on an [H, W] f32 image (0..255 scale).

    Returns fixed-capacity keypoints+descriptors with validity masks;
    capacity = num_octaves * 2 * max_pts_per_octave.

    Two jitted programs (dense detection, then keypoint sampling): a
    structural choice carried over from an earlier backend, unmeasured
    on the GPU.
    """
    offsets, subs = atlas_layout(img.shape, cfg)
    atlas, dets = _detect_stage(img, cfg)
    return _sample_stage(atlas, offsets, subs, dets, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "offsets", "subs"))
def _sample_stage(atlas, offsets, subs, dets, cfg: SiftConfig) -> SiftResult:
    # Concatenate detections in atlas coordinates and compact valid
    # ones to the front ONCE — outputs stay in compacted order (only
    # the small [K] metadata arrays are ever permuted, never the
    # [K, 128] block).
    x_a = jnp.concatenate([d.x for d in dets])
    y_a = jnp.concatenate([d.y for d in dets])  # already atlas-frame
    sc_a = jnp.concatenate([d.scale for d in dets])
    sharp_a = jnp.concatenate([d.sharpness for d in dets])
    edge_a = jnp.concatenate([d.edgeness for d in dets])
    valid_a = jnp.concatenate([d.valid for d in dets])
    oct_a = jnp.concatenate(
        [jnp.full(d.x.shape, i, jnp.int32) for i, d in enumerate(dets)]
    )
    sub_a = jnp.concatenate(
        [jnp.full(d.x.shape, s, jnp.float32) for d, s in zip(dets, subs)]
    )
    off_a = jnp.concatenate(
        [jnp.full(d.x.shape, off, jnp.float32) for d, off in zip(dets, offsets)]
    )

    # Cap the slot count the sampling stage sees: per-octave detection
    # capacity sums to num_octaves * max_pts_per_octave slots, but real
    # images fill a fraction of them, and the sampling gathers (and
    # every downstream [K,128] matmul) scale with SLOTS, not with
    # keypoints.  When the cap binds, keep the GLOBALLY strongest
    # detections (|interpolated DoG response|) across octaves — a plain
    # front-compaction would drop whole coarse octaves (concat order).
    cap = cfg.sample_cap
    K_slots = valid_a.shape[0]
    if cap and cap < K_slots and K_slots <= 16384:
        # Exact global strength ranking: at quality-config sizes the
        # cap BINDS (dino: ~2.5k detections in 5120 slots with
        # cap 2560), so the kept SET must be the globally strongest,
        # and the sort is cheap at this n.
        strength = jnp.where(valid_a, jnp.abs(sharp_a), -1.0)
        _, order = jax.lax.top_k(strength, cap)
        order = order.astype(jnp.int32)
    elif cap and cap < K_slots:
        # Capacity-class sizes (up-scale: 40960 slots): the cap does
        # NOT bind there (~10k detections in 16384 slots), so only the
        # ORDER matters and the exact sort is skipped.
        # Each octave's detections are already strength-sorted
        # (detect's top-k, valids as a prefix), so a STATIC
        # rank-major interleave (rank r of every octave before rank
        # r+1 of any) + an O(n) valid compaction gives a near-sorted
        # strong-first order without any sort; if the cap ever did
        # bind, the kept set is each octave's strongest prefix
        # (octave-balanced) rather than globally strongest.
        n_oct = len(dets)
        per = K_slots // n_oct
        j = np.arange(K_slots)
        perm = jnp.asarray((j % n_oct) * per + j // n_oct, jnp.int32)
        order = perm[compaction_order(valid_a[perm])[:cap]]
    else:
        order = compaction_order(valid_a)
    # ONE packed row gather instead of 9 per-array gathers: the slot
    # metadata rides as [K, 9] rows so the reorder fetches 36-byte
    # contiguous rows instead of 9 scalar streams.
    meta = jnp.stack(
        [x_a, y_a, sc_a, sharp_a, edge_a,
         valid_a.astype(jnp.float32), oct_a.astype(jnp.float32),
         sub_a, off_a], axis=1,
    )[order]
    x_a, y_a, sc_a, sharp_a, edge_a = (meta[:, i] for i in range(5))
    valid_a = meta[:, 5] > 0.5
    oct_a = meta[:, 6].astype(jnp.int32)
    sub_a, off_a = meta[:, 7], meta[:, 8]

    h = orient.orientation_histograms(atlas, x_a, y_a, sc_a)
    ori1, ori2, valid2 = orient.orientations_from_histograms(
        h, valid_a, duplicates=cfg.orientation_duplicates
    )
    valid2 = valid2 & valid_a

    # Primary + duplicate slots (fixed second slot replaces the
    # reference's atomicInc append of split-orientation keypoints).
    # Duplicates are rare, so compact the combined set once more.
    x2 = jnp.concatenate([x_a, x_a])
    y2 = jnp.concatenate([y_a, y_a])
    sc2 = jnp.concatenate([sc_a, sc_a])
    sharp2 = jnp.concatenate([sharp_a, sharp_a])
    edge2 = jnp.concatenate([edge_a, edge_a])
    ori_2 = jnp.concatenate([ori1, ori2])
    valid_2 = jnp.concatenate([valid_a, valid2])
    oct_2 = jnp.concatenate([oct_a, oct_a])
    sub_2 = jnp.concatenate([sub_a, sub_a])
    off_2 = jnp.concatenate([off_a, off_a])

    order2 = compaction_order(valid_2)
    x2, y2, sc2, sharp2, edge2, ori_2, valid_2, oct_2, sub_2, off_2 = (
        a[order2]
        for a in (x2, y2, sc2, sharp2, edge2, ori_2, valid_2, oct_2, sub_2, off_2)
    )

    desc = describe.extract_descriptors(atlas, x2, y2, sc2, ori_2)
    desc = desc * valid_2[:, None]

    kp = Keypoints(
        x=x2 * sub_2,
        y=(y2 - off_2) * sub_2,
        scale=sc2 * sub_2,
        sharpness=sharp2,
        edgeness=edge2,
        orientation=ori_2,
        octave=oct_2,
        valid=valid_2,
    )
    if cfg.up_scale:
        # Back to input-image pixels (reference RescalePositions(0.5),
        # cudaSiftH.cu:131).
        kp = kp._replace(x=kp.x * 0.5, y=kp.y * 0.5, scale=kp.scale * 0.5)
    return SiftResult(keypoints=kp, descriptors=desc)
