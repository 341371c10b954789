"""Incremental multi-view SfM: two-view bootstrap + PnP registration +
track propagation + triangulation of new points + global BA.

NO reference counterpart — the reference is strictly two-view (survey
§7 step 4; driver config 3 asks for the 10-image dino sequence).
Accelerator-first structure: per-image registration is ONE jitted step over
fixed-capacity map arrays (points, per-image point-id tables); the
host merely sequences images, mirroring how the reference's host
sequences kernel launches (src/main.cpp:240-307) but with all state
device-resident.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sfm_jax.config import PipelineConfig
from sfm_jax.geometry import camera, pnp, ransac, pose as pose_mod, refine, triangulate as tri
from sfm_jax.models import bundle_adjust as ba
from sfm_jax.models.two_view import gather_correspondences
from sfm_jax.sift import frontend, match as match_mod
from sfm_jax.utils.precision import f32_matmul


class MapState(NamedTuple):
    X: jax.Array          # [P_cap, 3] world points
    X_valid: jax.Array    # [P_cap] bool
    n_points: jax.Array   # [] int32
    R: jax.Array          # [M, 3, 3] world->camera
    t: jax.Array          # [M, 3]
    pose_valid: jax.Array  # [M] bool
    point_id: jax.Array   # [M, K] int32 (-1 = no 3D point)


class IncrementalResult(NamedTuple):
    state: MapState
    uv: jax.Array         # [M, K, 2] keypoint pixel coords
    kp_valid: jax.Array   # [M, K]
    ba_costs: jax.Array
    mean_reproj: jax.Array


def _empty_state(n_images, kp_capacity, pt_capacity, dtype=jnp.float32):
    return MapState(
        X=jnp.zeros((pt_capacity, 3), dtype),
        X_valid=jnp.zeros((pt_capacity,), bool),
        n_points=jnp.asarray(0, jnp.int32),
        R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n_images, 3, 3)),
        t=jnp.zeros((n_images, 3), dtype),
        pose_valid=jnp.zeros((n_images,), bool),
        point_id=jnp.full((n_images, kp_capacity), -1, jnp.int32),
    )


def _append_points(state: MapState, X_new, new_mask):
    """Scatter-append masked new points; returns (state, ids [K])."""
    ranks = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    ids = jnp.where(new_mask, state.n_points + ranks, -1)
    cap = state.X.shape[0]
    slot = jnp.where(new_mask & (ids < cap), ids, cap)  # cap = dropped
    X_pad = jnp.concatenate([state.X, jnp.zeros((1, 3), state.X.dtype)])
    X_pad = X_pad.at[slot].set(jnp.where(new_mask[:, None], X_new, 0.0))
    V_pad = jnp.concatenate([state.X_valid, jnp.zeros((1,), bool)])
    V_pad = V_pad.at[slot].set(new_mask)
    n_new = jnp.minimum(
        state.n_points + jnp.sum(new_mask, dtype=jnp.int32), cap
    )
    ids = jnp.where(ids < cap, ids, -1)
    return state._replace(
        X=X_pad[:cap], X_valid=V_pad[:cap], n_points=n_new
    ), ids


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_matmul
def _register_image(
    state: MapState,
    cur_idx,
    x_cur,      # [K, 3] normalized coords of current image keypoints
    prev_idx,   # [B] int32 previous frame indices (nearest first)
    x_prev,     # [B, K, 3]
    match_idx,  # [B, K] prev-slot -> cur-slot
    match_ok,   # [B, K]
    key,
    cfg: PipelineConfig,
):
    """PnP-register image cur_idx against B previous frames and extend
    the map.

    One fused XLA step: 2D-3D PnP RANSAC over the union of
    correspondences from every previous frame (longer tracks couple
    the pose chain far more stiffly than single-frame chaining — the
    r1/r2 bas-relief drift came from 2-frame tracks) + pose refine +
    new-point triangulation (against the nearest frame) + track
    bookkeeping.
    """
    B, K_slots = match_idx.shape
    pid_prev = state.point_id[prev_idx]              # [B, K]
    pid_safe = jnp.maximum(pid_prev, 0)
    X_corr = state.X[pid_safe]                       # [B, K, 3]
    x_obs = jnp.take_along_axis(
        jnp.broadcast_to(x_cur[None], (B,) + x_cur.shape),
        match_idx[..., None], axis=1,
    )                                                # [B, K, 3]
    corr_mask = (pid_prev >= 0) & match_ok & state.X_valid[pid_safe]

    rc = cfg.ransac
    # The previous frame's pose seeds the hypothesis set: on shallow
    # far-field geometry (turntable data) it routinely beats every
    # minimal 6-point DLT sample (r1: PnP spread 3..247 inliers across
    # seeds on the same problem; with the prior it is stable).
    res = pnp.ransac_pnp(
        key, x_obs.reshape(-1, 3), X_corr.reshape(-1, 3),
        corr_mask.reshape(-1),
        n_hyps=rc.n_hyps, threshold=rc.threshold * 4,
        R_init=state.R[prev_idx[0]], t_init=state.t[prev_idx[0]],
    )
    R_new, t_new = res.R, res.t
    ok_pose = res.num_inliers >= 12

    # Propagate track ids to current image (observations of existing
    # points).  Farther frames write FIRST so the nearest frame wins
    # slot conflicts.
    inl = res.inliers.reshape(B, K_slots)
    point_id_cur = jnp.full((K_slots,), -1, jnp.int32)
    for b in range(B - 1, -1, -1):
        inherit = corr_mask[b] & inl[b]
        point_id_cur = point_id_cur.at[
            jnp.where(inherit, match_idx[b], K_slots)
        ].set(jnp.where(inherit, pid_prev[b], -1), mode="drop")

    # Triangulate brand-new tracks against the NEAREST previous frame.
    p0 = prev_idx[0]
    fresh = match_ok[0] & (pid_prev[0] < 0)
    P_prev = tri.make_projection(state.R[p0], state.t[p0])
    P_cur = tri.make_projection(R_new, t_new)
    X_new, w_h, finite = tri.triangulate(x_prev[0], x_obs[0], P_prev, P_cur)
    # Quality gates: reprojection in both views + positive depth.
    z_prev = tri.depths(X_new, state.R[p0], state.t[p0])
    z_cur = tri.depths(X_new, R_new, t_new)
    e_prev = pnp.reprojection_residuals(state.R[p0], state.t[p0], x_prev[0], X_new)
    e_cur = pnp.reprojection_residuals(R_new, t_new, x_obs[0], X_new)
    good_new = (
        fresh & finite & (z_prev > 0) & (z_cur > 0)
        & (e_prev < rc.threshold * 4) & (e_cur < rc.threshold * 4)
        & ok_pose
    )
    state, new_ids = _append_points(state, X_new, good_new)

    # Record new ids in both images' tables.
    point_id_prev0 = jnp.where(new_ids >= 0, new_ids, state.point_id[p0])
    point_id_cur = point_id_cur.at[
        jnp.where(new_ids >= 0, match_idx[0], K_slots)
    ].set(jnp.where(new_ids >= 0, new_ids, -1), mode="drop")

    state = state._replace(
        R=state.R.at[cur_idx].set(jnp.where(ok_pose, R_new, jnp.eye(3, dtype=R_new.dtype))),
        t=state.t.at[cur_idx].set(jnp.where(ok_pose, t_new, 0.0)),
        pose_valid=state.pose_valid.at[cur_idx].set(ok_pose),
        point_id=state.point_id.at[p0].set(point_id_prev0)
                                .at[cur_idx].set(point_id_cur),
    )
    return state, res.num_inliers


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_matmul
def _apply_closure(
    state: MapState,
    i,           # [] int32 frame index
    j,           # [] int32 frame index
    x_i,         # [K, 3] normalized coords of frame i keypoints
    x_j,         # [K, 3]
    match_idx,   # [K] i-slot -> j-slot
    match_ok,    # [K]
    gate,        # [] squared-residual acceptance gate (see caller)
    cfg: PipelineConfig,
):
    """Fold one loop-closure pair (i, j) into the map.

    For every matched slot pair the track ids are reconciled
    (reprojection-gated against the CURRENT poses, the closure analog
    of the PnP gate used at registration):

      * one side has a 3D point -> the other side inherits the id
        (a new observation of an existing track);
      * both sides have DIFFERENT points -> the tracks are merged
        (all tables relabel j's id to i's; j's point is retired) —
        this is the constraint that ties the loop shut in global BA;
      * neither side has a point -> triangulate a fresh track from the
        two poses.

    NO reference counterpart (the reference is strictly two-view); this
    (`closure_pairs` accepted and
    ignored).
    """
    K_slots = match_idx.shape[0]
    R_i, t_i = state.R[i], state.t[i]
    R_j, t_j = state.R[j], state.t[j]
    pid_i = state.point_id[i]                      # [K]
    pid_j = state.point_id[j][match_idx]           # [K] at matched slots
    x_j_m = x_j[match_idx]                         # [K, 3]

    Xi = state.X[jnp.maximum(pid_i, 0)]
    Xj = state.X[jnp.maximum(pid_j, 0)]
    has_i = (pid_i >= 0) & state.X_valid[jnp.maximum(pid_i, 0)]
    has_j = (pid_j >= 0) & state.X_valid[jnp.maximum(pid_j, 0)]
    # Cross-frame reprojection gates (err includes behind-camera guard).
    err_i_in_j = pnp.reprojection_residuals(R_j, t_j, x_j_m, Xi)
    err_j_in_i = pnp.reprojection_residuals(R_i, t_i, x_i, Xj)

    inherit_j = match_ok & has_i & ~has_j & (err_i_in_j < gate)
    inherit_i = match_ok & has_j & ~has_i & (err_j_in_i < gate)
    merge = (
        match_ok & has_i & has_j & (pid_i != pid_j)
        & (err_i_in_j < gate) & (err_j_in_i < gate)
    )

    # --- merges: relabel pid_j -> pid_i everywhere, retire X[pid_j] ---
    cap = state.X.shape[0]
    remap = jnp.arange(cap + 1, dtype=jnp.int32)
    remap = remap.at[jnp.where(merge, pid_j, cap)].set(
        jnp.where(merge, pid_i, cap), mode="drop"
    )
    # Resolve merge chains by repeated self-composition: k passes
    # resolve chains of length 2^k, so ceil(log2(cap)) passes cover any
    # chain one closure call can build (each is a [cap+1] gather).
    for _ in range(max(1, (cap).bit_length())):
        remap = remap[remap]
    pid_tbl = jnp.where(
        state.point_id >= 0,
        remap[jnp.minimum(jnp.maximum(state.point_id, 0), cap - 1)],
        -1,
    )
    X_valid = state.X_valid.at[jnp.where(merge, pid_j, cap)].set(
        False, mode="drop"
    )
    state = state._replace(point_id=pid_tbl, X_valid=X_valid)
    pid_i = state.point_id[i]

    # --- inherits: record the closure observation in the bare table ---
    tbl_j = state.point_id[j].at[
        jnp.where(inherit_j, match_idx, K_slots)
    ].set(jnp.where(inherit_j, pid_i, -1), mode="drop")
    tbl_i = jnp.where(inherit_i, remap[jnp.minimum(pid_j, cap - 1)], pid_i)

    # --- fresh tracks: triangulate from the two closure poses ---
    fresh = match_ok & ~has_i & ~has_j & (pid_i < 0) & (pid_j < 0)
    P_i = tri.make_projection(R_i, t_i)
    P_j = tri.make_projection(R_j, t_j)
    X_new, _, finite = tri.triangulate(x_i, x_j_m, P_i, P_j)
    good_new = (
        fresh & finite
        & (tri.depths(X_new, R_i, t_i) > 0)
        & (tri.depths(X_new, R_j, t_j) > 0)
        & (pnp.reprojection_residuals(R_i, t_i, x_i, X_new) < gate)
        & (pnp.reprojection_residuals(R_j, t_j, x_j_m, X_new) < gate)
    )
    state, new_ids = _append_points(state, X_new, good_new)
    tbl_i = jnp.where(new_ids >= 0, new_ids, tbl_i)
    tbl_j = tbl_j.at[
        jnp.where(new_ids >= 0, match_idx, K_slots)
    ].set(jnp.where(new_ids >= 0, new_ids, -1), mode="drop")

    state = state._replace(
        point_id=state.point_id.at[i].set(tbl_i).at[j].set(tbl_j)
    )
    n_closed = (
        jnp.sum(merge) + jnp.sum(inherit_i) + jnp.sum(inherit_j)
        + jnp.sum(new_ids >= 0)
    )
    return state, n_closed


def build_ba_problem(state: MapState, uv_all, kp_valid, K_inv):
    """Flatten the point-id tables into a BAProblem (normalized uv)."""
    M, Ks = state.point_id.shape
    cam_idx = jnp.repeat(jnp.arange(M, dtype=jnp.int32), Ks)
    pid = state.point_id.reshape(-1)
    x = camera.normalize_points(uv_all.reshape(-1, 2), K_inv)
    mask = (
        (pid >= 0)
        & kp_valid.reshape(-1)
        & state.pose_valid[cam_idx]
        & state.X_valid[jnp.maximum(pid, 0)]
    )
    fixed = ~state.pose_valid | (jnp.arange(M) == 0)
    return ba.BAProblem(
        cam_idx=cam_idx,
        pt_idx=jnp.maximum(pid, 0),
        uv=x[:, :2] / x[:, 2:3],
        mask=mask,
        fixed=fixed,
    )


@functools.partial(jax.jit, static_argnames=("obs_cap",))
@f32_matmul
def _window_problem(problem: ba.BAProblem, pt_capacity_arr, win_lo, win_hi,
                    obs_cap: int):
    """Compact a full BAProblem to the observations a windowed local BA
    can actually move: cameras in [win_lo, win_hi] plus the
    fixed-camera observations constraining the points those cameras
    see.  Points are remapped to a dense [obs_cap] slot space so
    run_ba's per-iteration cost is O(window), not O(all frames)
    (the 36-frame ring otherwise pays ~36x
    the window's work by the last frames).

    Returns (problem_w, orig_pt [obs_cap] original point ids,
    slot_valid [obs_cap]).
    """
    from sfm_jax.ops.compact import compaction_order

    P = pt_capacity_arr.shape[0]
    cam_in = (problem.cam_idx >= win_lo) & (problem.cam_idx <= win_hi)
    seen_w = jnp.zeros((P,), bool).at[
        jnp.where(problem.mask & cam_in, problem.pt_idx, P)
    ].set(True, mode="drop")
    keep = problem.mask & (cam_in | seen_w[problem.pt_idx])
    # Window-camera observations first (stable compaction preserves
    # order within each class), so a cap overflow sheds fixed-camera
    # anchor terms before the window's own residuals.
    order1 = compaction_order(keep & cam_in)
    order2 = compaction_order(keep & ~cam_in)
    n1 = jnp.sum(keep & cam_in)
    n2 = jnp.sum(keep & ~cam_in)
    sl = jnp.arange(order1.shape[0], dtype=jnp.int32)
    order = jnp.where(sl < n1, order1, order2[jnp.maximum(sl - n1, 0)])
    order = order[:obs_cap]
    cam = problem.cam_idx[order]
    pt = problem.pt_idx[order]
    uv = problem.uv[order]
    # Gate by slot position, not just keep[order]: order2's tail (its
    # non-matching suffix) holds keep&cam_in rows already placed in the
    # order1 prefix — keep[order] alone would double-count them
    # whenever obs_cap > n1 + n2.
    msk = keep[order] & (sl[:obs_cap] < n1 + n2)
    # Dense remap of the surviving points into [0, obs_cap) slots.
    seen = jnp.zeros((P,), bool).at[
        jnp.where(msk, pt, P)
    ].set(True, mode="drop")
    new_id = jnp.cumsum(seen.astype(jnp.int32)) - 1          # [P]
    pt_new = jnp.where(msk, new_id[pt], 0)
    orig_pt = jnp.zeros((obs_cap,), jnp.int32).at[
        jnp.where(seen, new_id, obs_cap)
    ].set(jnp.arange(P, dtype=jnp.int32), mode="drop")
    slot_valid = jnp.arange(obs_cap) < jnp.sum(seen)
    return (
        ba.BAProblem(cam_idx=cam, pt_idx=pt_new, uv=uv, mask=msk,
                     fixed=problem.fixed),
        orig_pt,
        slot_valid,
    )


def _make_matcher(cfg: PipelineConfig, mesh):
    """Pairwise matcher: local, or sharded over the mesh (the matmul's
    N2 axis is sharded across devices via parallel.dist_match)."""
    if mesh is None:
        return lambda d1, d2, v1, v2: match_mod.match(d1, d2, v1, v2, cfg.match)
    from sfm_jax.parallel import dist_match, mesh as meshmod

    return lambda d1, d2, v1, v2: meshmod.gather_to_one(
        dist_match.dist_match(d1, d2, v1, v2, cfg.match, mesh=mesh), mesh
    )


@f32_matmul
def run_incremental(
    images,
    K,
    cfg: PipelineConfig = PipelineConfig(),
    *,
    seed: int = 0,
    pt_capacity: int | None = None,
    ba_iters: int = 20,
    local_ba_iters: int = 5,
    local_ba_window: int = 5,
    local_ba_obs_cap: int | None = None,
    n_back: int = 3,
    closure_pairs=(),
    closure_gate_mult: float = 64.0,
    mesh=None,
    feats=None,
):
    """Full incremental reconstruction over a list of [H, W] images.

    With `mesh`, the two heavy O(N^2)/O(M^2) stages run distributed:
    pairwise descriptor matching shards the right-hand keypoint set
    (parallel.dist_match) and the final global BA runs the
    point-partitioned Schur CG (parallel.dist_ba).  Their results come
    back as one copy on the mesh's first device (mesh.gather_to_one), so
    everything between them runs on one device.

    `local_ba_obs_cap`: observation capacity for the per-frame windowed
    local BA (see _window_problem).  None = auto
    ((local_ba_window + n_back + 2) * keypoint capacity — per-frame
    cost O(window) instead of O(all registered frames)); 0 = disable
    compaction (the pre-r4 behavior: every frame's local BA iterates
    over every observation slot of the whole sequence).

    `closure_pairs`: (i, j) frame pairs known (or suspected) to observe
    the same structure despite being far apart in the sequence — wrap
    edges on ring captures, revisits on general ones.  Each pair is
    matched and its tracks reconciled (inherit / merge / triangulate,
    see _apply_closure) before global BA, so the closure constraint
    participates in the joint solve.
    """
    n_images = len(images)
    K = jnp.asarray(K)
    K_inv = camera.inv_intrinsics(K)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_images + 1)

    if feats is None:
        feats = [
            frontend.extract_sift(jnp.asarray(im), cfg.sift) for im in images
        ]
    kp_cap = feats[0].keypoints.x.shape[0]
    if pt_capacity is None:
        pt_capacity = n_images * kp_cap // 4
    uv_all = jnp.stack(
        [jnp.stack([f.keypoints.x, f.keypoints.y], axis=-1) for f in feats]
    )
    kp_valid = jnp.stack([f.keypoints.valid for f in feats])
    x_norm = [
        camera.normalize_points(uv_all[i], K_inv) for i in range(n_images)
    ]

    state = _empty_state(n_images, kp_cap, pt_capacity)
    matcher = _make_matcher(cfg, mesh)

    # --- bootstrap from images (0, 1): essential + pose + triangulate ---
    m01 = matcher(
        feats[0].descriptors, feats[1].descriptors,
        feats[0].keypoints.valid, feats[1].keypoints.valid,
    )
    mask01 = m01.valid & kp_valid[0] & kp_valid[1][m01.index]
    # Degenerate-configuration rejection (see RansacConfig.min_disparity_px).
    disp2 = jnp.sum((uv_all[0] - uv_all[1][m01.index]) ** 2, axis=-1)
    mask01 = mask01 & (disp2 > cfg.ransac.min_disparity_px ** 2)
    x1b = x_norm[0]
    x2b = x_norm[1][m01.index]
    rr = ransac.ransac_essential(
        keys[0], x1b, x2b, mask01,
        n_hyps=cfg.ransac.n_hyps, threshold=cfg.ransac.threshold,
        chunk=cfg.ransac.chunk, refit_iters=cfg.ransac.refit_iters,
    )
    p = pose_mod.recover_pose(rr.E, x1b, x2b, weights=rr.inliers.astype(jnp.float32))
    ref = refine.refine_relative_pose(
        p["R"], p["t"], x1b, x2b, weights=rr.inliers, iters=cfg.refine_iters
    )
    # Re-vote cheirality on the refined E (see two_view).
    p2 = pose_mod.recover_pose(ref.E, x1b, x2b,
                               weights=rr.inliers.astype(jnp.float32))
    ref = ref._replace(R=p2["R"], t=p2["t"])
    P1 = tri.make_projection(jnp.eye(3), jnp.zeros(3))
    P2 = tri.make_projection(ref.R, ref.t)
    X01, _, finite01 = tri.triangulate(x1b, x2b, P1, P2)
    z1 = X01[..., 2]
    z2 = tri.depths(X01, ref.R, ref.t)
    good01 = rr.inliers & finite01 & (z1 > 0) & (z2 > 0)
    state, ids01 = _append_points(state, X01, good01)
    pid0 = jnp.where(ids01 >= 0, ids01, -1)
    pid1 = jnp.full((kp_cap,), -1, jnp.int32).at[
        jnp.where(ids01 >= 0, m01.index, kp_cap)
    ].set(jnp.where(ids01 >= 0, ids01, -1), mode="drop")
    state = state._replace(
        R=state.R.at[1].set(ref.R),
        t=state.t.at[1].set(ref.t),
        pose_valid=state.pose_valid.at[0].set(True).at[1].set(True),
        point_id=state.point_id.at[0].set(pid0).at[1].set(pid1),
    )

    # --- incremental registration (2D-3D from n_back previous frames:
    # multi-frame tracks stiffen the chain against bas-relief drift) ---
    for i in range(2, n_images):
        backs = list(range(i - 1, max(i - 1 - n_back, -1), -1))
        midx, mok = [], []
        for p in backs:
            m = matcher(
                feats[p].descriptors, feats[i].descriptors,
                feats[p].keypoints.valid, feats[i].keypoints.valid,
            )
            midx.append(m.index)
            mok.append(m.valid & kp_valid[p] & kp_valid[i][m.index])
        # Pad to a fixed B so one compiled program serves every frame.
        while len(backs) < n_back:
            backs.append(backs[-1])
            midx.append(midx[-1])
            mok.append(jnp.zeros_like(mok[-1]))
        state, n_inl = _register_image(
            state, i, x_norm[i],
            jnp.asarray(backs, jnp.int32),
            jnp.stack([x_norm[p] for p in backs]),
            jnp.stack(midx), jnp.stack(mok),
            keys[i], cfg,
        )
        # Windowed local BA after each registration: polish the last
        # `local_ba_window` poses + map against ALL their observations.
        # Early-pair drift (small-baseline bootstrap noise) otherwise
        # contaminates every later PnP registration — r1's admitted
        # fragility.  Shapes are identical each frame, so this reuses
        # one compiled program; `fixed` pins cameras outside the window
        # (and camera 0) for gauge and scale.
        if local_ba_iters:
            problem_i = build_ba_problem(state, uv_all, kp_valid, K_inv)
            idx = jnp.arange(n_images)
            win_lo = i - local_ba_window + 1
            fixed_i = problem_i.fixed | (idx < win_lo)
            problem_i = problem_i._replace(fixed=fixed_i)
            if local_ba_obs_cap != 0:
                # Compact to the window's observations (+ the fixed-
                # camera anchors of its points) so run_ba's cost is
                # O(window) per frame, not O(all registered frames).
                cap = local_ba_obs_cap or (
                    (local_ba_window + n_back + 2) * kp_cap
                )
                if cap < problem_i.mask.shape[0]:
                    prob_w, orig_pt, slot_ok = _window_problem(
                        problem_i, state.X_valid,
                        jnp.asarray(win_lo, jnp.int32),
                        jnp.asarray(i, jnp.int32), cap,
                    )
                    X_w = state.X[orig_pt]
                    st_i, _ = ba.run_ba(
                        state.R, state.t, X_w, prob_w,
                        iters=local_ba_iters,
                    )
                    pcap = state.X.shape[0]
                    X_new = state.X.at[
                        jnp.where(slot_ok, orig_pt, pcap)
                    ].set(st_i.X, mode="drop")
                    state = state._replace(R=st_i.R, t=st_i.t, X=X_new)
                else:
                    st_i, _ = ba.run_ba(
                        state.R, state.t, state.X, problem_i,
                        iters=local_ba_iters,
                    )
                    state = state._replace(R=st_i.R, t=st_i.t, X=st_i.X)
            else:
                st_i, _ = ba.run_ba(
                    state.R, state.t, state.X, problem_i,
                    iters=local_ba_iters,
                )
                state = state._replace(R=st_i.R, t=st_i.t, X=st_i.X)

    # Window compaction leaves points that dropped out of every window
    # unpolished since the frame that last saw them; one point-only LM
    # pass (every camera pinned) refreshes them at O(total) cost ONCE
    # instead of per frame, so the closure gates below and the global
    # BA init see current coordinates (the uncompacted local BA got
    # this for free by polishing all points every frame).
    if local_ba_iters and local_ba_obs_cap != 0:
        problem_p = build_ba_problem(state, uv_all, kp_valid, K_inv)
        st_p, _ = ba.run_ba(
            state.R, state.t, state.X,
            problem_p._replace(fixed=jnp.ones_like(problem_p.fixed)),
            iters=3,
        )
        state = state._replace(X=st_p.X)

    # --- loop closure: reconcile tracks across the declared far pairs
    # (wrap edges on ring sequences, revisits on general ones) BEFORE
    # the global BA so the merged tracks tie the loop shut ---
    # The closure gate must admit DRIFT-scale reprojection error — the
    # whole point of the edge is that the two ends disagree by the
    # accumulated drift; a registration-tight gate rejects exactly the
    # merges that correct it.  False merges are caught downstream by
    # the global-BA outlier pruning (25x median).
    closure_gate = jnp.asarray(cfg.ransac.threshold * 4 * closure_gate_mult,
                               jnp.float32)
    for ci, cj in closure_pairs:
        m = matcher(
            feats[ci].descriptors, feats[cj].descriptors,
            feats[ci].keypoints.valid, feats[cj].keypoints.valid,
        )
        mok = m.valid & kp_valid[ci] & kp_valid[cj][m.index]
        state, _ = _apply_closure(
            state, jnp.asarray(ci, jnp.int32), jnp.asarray(cj, jnp.int32),
            x_norm[ci], x_norm[cj], m.index, mok, closure_gate, cfg,
        )

    _part = {}  # partition layout cache across the two global-BA rounds

    def _global_ba(R, t, X, problem, iters):
        if mesh is None:
            final, costs = ba.run_ba(R, t, X, problem, iters=iters)
            return final.R, final.t, final.X, costs
        from sfm_jax.parallel import dist_ba, mesh as meshmod

        if not _part:
            # O(D*O) host partition: run it ONCE — the second round only
            # shrinks the mask (subset of round 1's), so the layout can
            # be reused via obs_idx.
            X_sh, prob_sh, obs_idx = dist_ba.partition_problem(
                problem, X, mesh.size, return_layout=True
            )
            _part["prob"] = prob_sh
            _part["obs_idx"] = obs_idx
        else:
            obs_idx = _part["obs_idx"]
            mask_sh = jnp.where(
                obs_idx >= 0, problem.mask[jnp.maximum(obs_idx, 0)], False
            )
            prob_sh = _part["prob"]._replace(mask=mask_sh)
            X_sh = dist_ba.partition_points(X, mesh.size)
        R_f, t_f, X_sh_f, costs = meshmod.gather_to_one(
            dist_ba.run_dist_ba(R, t, X_sh, prob_sh, mesh, iters=iters), mesh
        )
        return R_f, t_f, dist_ba.unpartition_points(X_sh_f, X.shape[0]), costs

    # --- global bundle adjustment with one outlier-pruning round ---
    problem = build_ba_problem(state, uv_all, kp_valid, K_inv)
    R_f, t_f, X_f, costs = _global_ba(
        state.R, state.t, state.X, problem, ba_iters
    )
    # Prune gross-residual observations (wrong matches that survived
    # RANSAC) and polish — the reference has no such loop (it has no BA
    # at all, README.md:42).
    r = ba._residuals(R_f, t_f, X_f, problem)
    rn2 = jnp.sum(r * r, axis=-1)
    med = jnp.nanmedian(jnp.where(problem.mask, rn2, jnp.nan))
    gate = 25.0 * jnp.nan_to_num(med, nan=1e-6) + 1e-12
    keep = problem.mask & (rn2 < gate)
    # Re-triangulate failed tracks with the BA-refined poses: a track
    # pruned to < 2 surviving observations usually had a bad INITIAL
    # triangulation (small baseline at bootstrap), not bad matches —
    # one multiview DLT over the refined poses rescues it (the
    # reference has no BA, so no such loop).
    pcap = X_f.shape[0]
    X_rt, ok_rt = tri.triangulate_tracks(
        R_f, t_f, problem.cam_idx, problem.pt_idx, problem.uv,
        problem.mask, pcap,
    )
    rn2_rt = jnp.sum(ba._residuals(R_f, t_f, X_rt, problem) ** 2, axis=-1)
    keep_rt = problem.mask & (rn2_rt < gate)
    kept_cnt = jnp.zeros((pcap,), jnp.int32).at[problem.pt_idx].add(
        keep.astype(jnp.int32)
    )
    rt_cnt = jnp.zeros((pcap,), jnp.int32).at[problem.pt_idx].add(
        keep_rt.astype(jnp.int32)
    )
    accept = ok_rt & (kept_cnt < 2) & (rt_cnt >= 2)
    X_f = jnp.where(accept[:, None], X_rt, X_f)
    # For rescued points the re-triangulated gate is the only honest
    # one: an old observation that passed under the STALE coordinates
    # must not survive into the second global BA against X_rt.
    keep = jnp.where(accept[problem.pt_idx], keep_rt, keep)
    problem2 = problem._replace(mask=keep)
    R_f, t_f, X_f, costs2 = _global_ba(
        R_f, t_f, X_f, problem2, max(ba_iters // 2, 5)
    )
    state = state._replace(R=R_f, t=t_f, X=X_f)
    r = ba._residuals(R_f, t_f, X_f, problem2)
    denom = jnp.maximum(jnp.sum(problem2.mask), 1)
    mean_reproj = jnp.sum(
        jnp.where(problem2.mask, jnp.sum(r * r, -1), 0.0)
    ) / denom
    return IncrementalResult(
        state=state, uv=uv_all, kp_valid=kp_valid,
        ba_costs=jnp.concatenate([costs, costs2]), mean_reproj=mean_reproj,
    )
