"""Two-view Structure-from-Motion pipeline (the reference's flagship).

Equivalent of the reference's end-to-end flow
(reference src/main.cpp:240-307): SIFT -> match -> normalize ->
RANSAC E -> pose candidates + cheirality -> triangulation — plus the
on-manifold pose refinement the reference lacks.  The geometry stage
runs as ONE jitted program with zero host round trips (the reference
crosses the device boundary at the RANSAC shuffle, best-E selection,
3x3 SVD, and four cheirality readbacks — survey §1 data-flow notes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_jax.config import PipelineConfig
from sfm_jax.geometry import camera, ransac, pose, refine, triangulate as tri
from sfm_jax.sift import frontend, match as match_mod
from sfm_jax.utils.precision import f32_matmul


class TwoViewResult(NamedTuple):
    R: jax.Array            # [3,3] second-camera rotation
    t: jax.Array            # [3] unit translation
    E: jax.Array            # [3,3] refined essential matrix
    points: jax.Array       # [N,3] triangulated points (camera-1 frame)
    point_valid: jax.Array  # [N] bool (inlier & cheirality & finite)
    uv1: jax.Array          # [N,2] pixel coords image 1
    uv2: jax.Array          # [N,2] pixel coords image 2
    inliers: jax.Array      # [N] RANSAC inlier mask
    num_inliers: jax.Array
    num_matches: jax.Array
    reproj_err: jax.Array   # mean squared reprojection error (normalized)


def gather_correspondences(kp1, desc1, kp2, desc2, matches):
    """Dense [N,2] pixel correspondence arrays from a match result.

    Equivalent of the reference's copy_point gather
    (SfM/kernels.h:261-279) — here N is the fixed keypoint capacity and
    invalid rows are masked, not compacted.
    """
    uv1 = jnp.stack([kp1.x, kp1.y], axis=-1)
    uv2 = jnp.stack([kp2.x[matches.index], kp2.y[matches.index]], axis=-1)
    mask = matches.valid & kp1.valid & kp2.valid[matches.index]
    return uv1, uv2, mask


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_matmul
def two_view_geometry(key, uv1, uv2, mask, K, cfg: PipelineConfig = PipelineConfig()):
    """RANSAC + pose + refine + triangulate from pixel correspondences.

    One fused XLA program: the equivalent of the reference's
    fillXU/estimateE/computePosecandidates/choosePose/
    linear_triangulation call chain (src/main.cpp:299-307).
    """
    K_inv = camera.inv_intrinsics(K)
    x1 = camera.normalize_points(uv1, K_inv)
    x2 = camera.normalize_points(uv2, K_inv)

    rc = cfg.ransac
    disparity_ok = (
        jnp.sum((uv1 - uv2) ** 2, axis=-1) > rc.min_disparity_px ** 2
    )
    est_mask = mask & disparity_ok
    res = ransac.ransac_essential(
        key, x1, x2, est_mask,
        n_hyps=rc.n_hyps, threshold=rc.threshold, chunk=rc.chunk,
        sweeps=rc.sweeps, refit_iters=rc.refit_iters,
        topk=max(cfg.restart_k, 1),
    )
    from sfm_jax.geometry import epipolar

    # First vote only picks a candidate branch + seeds refinement; a
    # compacted subset decides it identically (cfg.vote_cap).  The
    # subset is compacted by RANSAC-inlier membership HERE rather than
    # assuming the caller packed valid rows first (a direct caller, or
    # geometry_cap=0, hands over masked-not-compacted slots — a plain
    # [:vc] slice could then vote on mostly-dead rows).
    if cfg.vote_cap and cfg.vote_cap < x1.shape[0]:
        from sfm_jax.ops.compact import compaction_order

        vsel = compaction_order(res.inliers)[: cfg.vote_cap]
        x1v, x2v = x1[vsel], x2[vsel]
        wv = res.inliers[vsel].astype(x1.dtype)
    else:
        x1v, x2v = x1, x2
        wv = res.inliers.astype(x1.dtype)
    # Refine <-> re-vote <-> re-score rounds with a branchless best-of
    # selection (see PipelineConfig.refine_rounds).  The Sampson
    # objective is invariant to the 4-fold (R, t) ambiguity of E, so
    # each round re-runs the cheirality vote on the REFINED essential
    # matrix (refinement can move the pose far once the degenerate
    # static-match attractor is filtered out, so branch-nearest
    # selection is NOT safe — the vote is).  recover_pose triangulates
    # every correspondence against the winning candidate, so the
    # winning round's points come for free.
    best = None

    def consider(cand, best):
        if best is None:
            return cand
        take = cand[0] > best[0]
        return tuple(jnp.where(take, c, b) for c, b in zip(cand, best))

    # Lexicographic packing multiplier for the tight-count score: must
    # exceed any possible valid count so one extra tight inlier always
    # outranks any number of loose ones (a fixed multiplier would
    # silently corrupt ranking when N can reach it, e.g.
    # geometry_cap=0 at full keypoint capacity).  tight <= N, so
    # tight * (N + 1) + score <= N^2 + 2N < 2^31 for N <= 46k.
    assert x1.shape[0] < 46000, "score packing overflows int32 at this N"
    score_mult = jnp.int32(x1.shape[0] + 1)

    def score_E(E, R2, t2):
        """Full-set round score: epipolar inliers that also pass the
        closed-form midpoint cheirality test at (R2, t2) — ~10 ops per
        point instead of the 4x N DLT solves of a full recover_pose;
        only the WINNING candidate pays for the full triangulation
        (below).

        Score = tight-inlier count (residual < threshold *
        score_tight_mult) lexicographically above the full valid
        count: the RANSAC threshold (3e-6 normalized ~ 4 px) is loose
        enough that a geometrically bad basin can ADMIT more loose
        inliers than the true pose — the tight count separates them
        while the full count still breaks ties."""
        E_n = E * (jnp.sqrt(2.0) / jnp.linalg.norm(E))
        r = epipolar.epipolar_residuals(E_n, x1, x2)
        inl = (r < rc.threshold) & mask
        z1, z2 = tri.midpoint_depths(x1, x2, R2, t2)
        cheir = (z1 > 0) & (z2 > 0)
        valid_k = inl & cheir
        score = jnp.sum(valid_k).astype(jnp.int32)
        if cfg.score_tight_mult > 0:
            tight = jnp.sum(
                (r < rc.threshold * cfg.score_tight_mult) & mask & cheir
            ).astype(jnp.int32)
            score = tight * score_mult + score
        return inl, valid_k, score

    # Multi-start selection: refinement's basin of attraction is
    # decided by its starting pose, and on a fraction of seeds the
    # single best RANSAC draw is NOT in the global basin (no amount of
    # re-voting or extra rounds rescues a bad start whose R is off).  Score ALL 4 pose branches of the LO-refit
    # E plus the top-K bank draws with the same tight-count metric the
    # rounds use (batched: one [C, N] residual bank + vmapped midpoint
    # depths, ~10 ops/point/candidate — no DLT) and start from the
    # argmax.  restart_k=0 falls back to the single-start cheirality
    # vote.
    if cfg.restart_k > 0:
        E_cands = jnp.concatenate([res.E[None], res.topk_E])    # [C,3,3]
        E_cands = E_cands * (
            jnp.sqrt(2.0)
            / jnp.linalg.norm(E_cands, axis=(1, 2), keepdims=True)
        )
        Rs, ts = pose.pose_candidates(E_cands)      # [C,4,3,3], [C,4,3]
        C = E_cands.shape[0]
        Rs = Rs.reshape(C * 4, 3, 3)
        ts = ts.reshape(C * 4, 3)
        rb = epipolar.epipolar_residuals(E_cands, x1, x2)       # [C, N]
        rb = jnp.repeat(rb, 4, axis=0)                          # [4C, N]
        z1b, z2b = jax.vmap(tri.midpoint_depths, (None, None, 0, 0))(
            x1, x2, Rs, ts
        )
        cheir = (z1b > 0) & (z2b > 0)
        validb = (rb < rc.threshold) & mask[None, :] & cheir
        scoreb = jnp.sum(validb, axis=-1).astype(jnp.int32)
        if cfg.score_tight_mult > 0:
            tightb = jnp.sum(
                (rb < rc.threshold * cfg.score_tight_mult)
                & mask[None, :] & cheir, axis=-1,
            ).astype(jnp.int32)
            scoreb = tightb * score_mult + scoreb
        if cfg.probe_starts > 1:
            # Probe refinement: refine the best branch of each of
            # the top-S E candidates with a short vmapped GN and pick
            # the start by POST-probe tight score — the pre-refinement
            # score is a weak basin predictor (PipelineConfig notes).
            sb4 = scoreb.reshape(C, 4)
            br = jnp.argmax(sb4, axis=1)                        # [C]
            flat = jnp.arange(C) * 4 + br
            S = min(cfg.probe_starts, C)
            _, esel = jax.lax.top_k(jnp.max(sb4, axis=1), S)    # [S]
            psel = flat[esel]
            R0s, t0s = Rs[psel], ts[psel]                       # [S,3,3]
            w0s = validb[psel].astype(x1.dtype)                 # [S,N]
            pref = jax.vmap(
                lambda R0, t0, w0: refine.refine_relative_pose(
                    R0, t0, x1, x2, weights=w0, iters=cfg.probe_iters
                )
            )(R0s, t0s, w0s)
            E_p = pref.E * (
                jnp.sqrt(2.0)
                / jnp.linalg.norm(pref.E, axis=(1, 2), keepdims=True)
            )
            rp = epipolar.epipolar_residuals(E_p, x1, x2)       # [S,N]
            z1p, z2p = jax.vmap(tri.midpoint_depths, (None, None, 0, 0))(
                x1, x2, pref.R, pref.t
            )
            cheirp = (z1p > 0) & (z2p > 0)
            validp = (rp < rc.threshold) & mask[None, :] & cheirp
            scorep = jnp.sum(validp, axis=-1).astype(jnp.int32)
            if cfg.score_tight_mult > 0:
                tightp = jnp.sum(
                    (rp < rc.threshold * cfg.score_tight_mult)
                    & mask[None, :] & cheirp, axis=-1,
                ).astype(jnp.int32)
                scorep = tightp * score_mult + scorep
            pw = jnp.argmax(scorep)
            R_cur, t_cur = pref.R[pw], pref.t[pw]
            w = validp[pw]
            # The probed winner enters the best-of selection directly:
            # consider() is monotone, so if the subsequent full rounds
            # diverge the probe result still wins.
            inl_p = (rp[pw] < rc.threshold) & mask
            best = consider(
                (scorep[pw], E_p[pw], inl_p, R_cur, t_cur), best
            )
        else:
            bsel = jnp.argmax(scoreb)
            R_cur, t_cur = Rs[bsel], ts[bsel]
            w = validb[bsel]
    else:
        p = pose.recover_pose(res.E, x1v, x2v, weights=wv)
        R_cur, t_cur = p["R"], p["t"]
        w = res.inliers

    for _round in range(max(cfg.refine_rounds, 1)):
        ref = refine.refine_relative_pose(
            R_cur, t_cur, x1, x2, weights=w, iters=cfg.refine_iters,
        )
        # Branch vote on the subset; full-set scoring via score_E.
        p2 = pose.recover_pose(ref.E, x1v, x2v, weights=wv)
        inl, valid_k, score = score_E(ref.E, p2["R"], p2["t"])
        best = consider((score, ref.E, inl, p2["R"], p2["t"]), best)
        R_cur, t_cur = p2["R"], p2["t"]
        # Cheirality-consistent inliers drive the next refinement: on
        # the bas-relief ridge the plain epipolar inliers can pull the
        # polish toward a pose that puts a third of them behind a
        # camera.
        w = valid_k

    # Translation re-vote rounds: local refinement cannot leave a
    # Sampson-flat valley whose pose buries a third of the inliers
    # behind a camera (rotation-dominant pairs).  Globally re-vote the
    # translation direction for the best R (pose.cheirality_t_vote),
    # enter the voted E as a candidate, and re-refine from the voted
    # pose.
    maskv = wv > 0
    for _vr in range(cfg.tvote_rounds):
        Rb = best[3]
        vote = pose.cheirality_t_vote(
            Rb, x1v, x2v, maskv, rc.threshold, n_dirs=cfg.tvote_dirs,
        )
        inl_s, valid_s, score_s = score_E(vote["E"], Rb, vote["t"])
        best = consider((score_s, vote["E"], inl_s, Rb, vote["t"]), best)
        ref = refine.refine_relative_pose(
            Rb, vote["t"], x1, x2, weights=valid_s, iters=cfg.refine_iters,
        )
        p2 = pose.recover_pose(ref.E, x1v, x2v, weights=wv)
        inl, valid_k, score = score_E(ref.E, p2["R"], p2["t"])
        best = consider((score, ref.E, inl, p2["R"], p2["t"]), best)

    # Final vote-only half round: the last refine may have improved R,
    # and re-voting t against it costs two matmuls + a score, far less
    # than a full vote+refine round.  consider() is monotone, so this
    # can only help.
    if cfg.tvote_rounds > 0:
        Rb = best[3]
        vote = pose.cheirality_t_vote(
            Rb, x1v, x2v, maskv, rc.threshold, n_dirs=cfg.tvote_dirs,
        )
        inl_s, _, score_s = score_E(vote["E"], Rb, vote["t"])
        best = consider((score_s, vote["E"], inl_s, Rb, vote["t"]), best)

    _, E_fin, inl, _, _ = best
    # Full recover_pose on the winner: final branch vote over every
    # point + the output triangulation (reference linear_triangulation,
    # SfM/sfm.cu:309-344).
    pf = pose.recover_pose(E_fin, x1, x2, weights=inl.astype(x1.dtype))
    R_fin, t_fin = pf["R"], pf["t"]
    X = pf["points"]
    pt_valid = inl & pf["front"] & pf["finite"]
    errs = tri.reprojection_errors(X, x1, x2, R_fin, t_fin)
    denom = jnp.maximum(jnp.sum(pt_valid), 1)
    mean_err = jnp.sum(jnp.where(pt_valid, errs, 0.0)) / denom
    return TwoViewResult(
        R=R_fin, t=t_fin, E=E_fin,
        points=X, point_valid=pt_valid,
        uv1=uv1, uv2=uv2,
        inliers=inl,
        num_inliers=jnp.sum(inl).astype(jnp.int32),
        num_matches=jnp.sum(mask).astype(jnp.int32),
        reproj_err=mean_err,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _match_stage(s1, s2, cfg: PipelineConfig):
    m = match_mod.match(
        s1.descriptors, s2.descriptors, s1.keypoints.valid, s2.keypoints.valid,
        cfg.match,
    )
    uv1, uv2, mask = gather_correspondences(
        s1.keypoints, s1.descriptors, s2.keypoints, s2.descriptors, m
    )
    # Compact valid correspondences to the front and cap the slot count
    # the geometry program sees: RANSAC scoring and triangulation cost
    # O(slots), and the raw keypoint capacity is ~8x the real match
    # count.  Matches beyond the cap (never hit on real imagery at the
    # default configs) are dropped, not corrupted — mask stays honest.
    cap = cfg.geometry_cap
    if cap and cap < mask.shape[0]:
        from sfm_jax.ops.compact import compaction_order

        order = compaction_order(mask)[:cap]
        uv1, uv2, mask = uv1[order], uv2[order], mask[order]
    return uv1, uv2, mask


def frontend_stage(img1, img2, cfg: PipelineConfig = PipelineConfig()):
    """SIFT x2 + match + correspondence gather (several pipelined
    dispatches; see sift.frontend.extract_sift).  Sequential per-image
    extraction rather than a batched one: a structural choice carried
    over from an earlier backend, unmeasured on the GPU."""
    s1 = frontend.extract_sift(img1, cfg.sift)
    s2 = frontend.extract_sift(img2, cfg.sift)
    return _match_stage(s1, s2, cfg)


def two_view_pipeline(img1, img2, K, key, cfg: PipelineConfig = PipelineConfig()):
    """Full pipeline from two [H, W] f32 images (0..255).

    Two jitted dispatches (frontend stage, geometry stage) with no
    eager glue.  The split into two programs is a structural choice
    carried over from an earlier backend, unmeasured on the GPU.
    """
    uv1, uv2, mask = frontend_stage(img1, img2, cfg)
    return two_view_geometry(key, uv1, uv2, mask, K, cfg)


def run_two_view(img1, img2, K, cfg: PipelineConfig = PipelineConfig(), seed: int = 0):
    """Convenience wrapper building the PRNG key from an int seed."""
    return two_view_pipeline(img1, img2, K, jax.random.PRNGKey(seed), cfg)
