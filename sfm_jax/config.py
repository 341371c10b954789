"""Configuration surface for the framework.

The reference hard-codes every knob (survey §5 lists the full set:
src/main.cpp:243-307, CudaSift/cudaSiftD.h:8-42, SfM/sfm.cu:95,220,50-52);
here they are explicit dataclasses, hashable so they can be passed as
static args to jitted pipelines.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT frontend (reference defaults: src/main.cpp:269-277)."""

    num_octaves: int = 5
    num_scales: int = 5          # NUM_SCALES (cudaSiftD.h:8)
    init_blur: float = 1.5       # prefilter sigma (src/main.cpp:269)
    thresh: float = 1.0          # DoG threshold, 0..255 intensity scale
    edge_limit: float = 10.0     # tr^2 < limit*det (cudaSiftH.cu:213)
    lowest_scale: float = 0.0    # min accepted blob scale
    up_scale: bool = False       # 2x upscale path (cudaSiftH.cu:119-133)
    max_pts_per_octave: int = 1024   # capacity replacing atomic append
    orientation_duplicates: bool = True  # 2nd-peak duplication (cudaSiftD.cu:1041)
    laplace_radius: int = 4      # LAPLACE_R (cudaSiftD.h:40)
    lowpass_radius: int = 4      # LOWPASS_R (cudaSiftD.h:44)
    # Slot cap for the sampling stage (orientation/descriptor gathers
    # and the descriptor matmuls downstream all scale with SLOTS): the
    # per-octave top-k capacities sum to num_octaves*max_pts_per_octave
    # but real images fill a fraction.  0 = no cap.  2048 silently cost
    # ~20% of the dino pair's matches; 2560 keeps the full match set.
    sample_cap: int = 2560
    # Candidate-selection mode for detect:
    #   "topk"    exact lax.top_k (default) — strongest-first under
    #             capacity pressure;
    #   "approx"  approx_max_k;
    #   "compact" O(n) cumsum compaction in scan order — the
    #             reference's append semantics (cudaSiftD.cu:1420);
    #             keeps ARBITRARY candidates when an octave saturates.
    select: str = "topk"
    # Optional PER-OCTAVE detection slot caps (overrides
    # max_pts_per_octave when set; length must equal num_octaves).
    # Detection counts fall roughly 2x per octave, while a uniform cap
    # makes every octave pay top-k + gather + sample-slot cost for its
    # full capacity.  None = uniform caps.
    octave_caps: tuple | None = None
    # Block size of the exact 2-level top-k prefilter
    # (detect._topk_2level): lax.top_k cost ~ level1 n/b + level2 k*b,
    # balanced at b ~ sqrt(n/k).
    topk_block: int = 32


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Brute-force matcher (reference CudaSift/matching.cu:1090-1206)."""

    max_ambiguity: float = 0.95  # ratio-test cutoff (ImproveHomography uses 0.95)
    min_score: float = 0.0       # min correlation of best match
    mutual: bool = False         # cross-check (not in reference)
    # Score product: bf16 operands with f32 accumulation (True), or f32
    # at HIGHEST precision (False).
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC (reference SfM/sfm.cu:94-236)."""

    n_hyps: int = 4096           # reference: floor(N/8) (sfm.cu:95)
    threshold: float = 1e-6      # symmetric epipolar dist^2, normalized coords
    chunk: int = 512
    refit_iters: int = 2
    # Jacobi sweep count for the fixed-sweep eigensolvers (svd3x3
    # method="jacobi" / triangulate solver="jacobi", the defaults).
    # The analytic closed-form paths ignore it.
    sweeps: int = 10
    # Degenerate-configuration rejection: matches with pixel disparity
    # below this satisfy x^T E x = 0 for ANY skew-symmetric E (static
    # background on turntable data), poisoning the vote with a
    # near-identity solution.  The reference has no such guard and its
    # RANSAC can land on the degenerate branch nondeterministically.
    min_disparity_px: float = 1.5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SiftConfig = SiftConfig()
    match: MatchConfig = MatchConfig()
    ransac: RansacConfig = RansacConfig()
    refine_iters: int = 10       # on-manifold pose refinement (beyond reference)
    # Refine <-> re-vote <-> re-score rounds.  The Sampson polish and
    # the cheirality vote interact: near the bas-relief ridge a single
    # round can land on a pose where many epipolar inliers fail the
    # depth test.  Each round re-weights the refinement by the
    # CHEIRALITY-CONSISTENT inliers of the previous one, and the final
    # result is the best round by valid-point count (branchless select;
    # round 1 reproduces the single-round behavior, so extra rounds can
    # only gain).
    refine_rounds: int = 2
    # Translation re-vote rounds after the refine rounds: on
    # rotation-dominant pairs the Sampson objective is flat in t, and
    # local refinement gets stuck in valleys whose recovered pose puts
    # hundreds of inliers behind a camera.  Each round globally
    # searches the t-sphere for the max-cheirality direction given the
    # best round's R (geometry.pose.cheirality_t_vote — two matmuls
    # over a Fibonacci bank), enters the voted E as a candidate, and
    # re-refines from the voted pose; a final vote-only half round
    # always follows.  0 disables both.
    tvote_rounds: int = 1
    # Size of the direction bank (a seed's good basin was missed at
    # 512 in a CPU seed study).
    tvote_dirs: int = 1024
    # Round-selection tightening: candidates are ranked by the count of
    # inliers at threshold * score_tight_mult (lexicographically above
    # the full valid count).  The full RANSAC threshold (~4 px at the
    # dino intrinsics) is loose enough that a geometrically bad basin
    # can admit MORE loose inliers than the true pose; the tight count
    # separates the basins.  0 disables (pure valid-count ranking).
    score_tight_mult: float = 0.25
    # Multi-start refinement: score all 4 pose branches of the LO-refit
    # E plus the top-restart_k RANSAC bank draws (tight-count metric,
    # batched closed-form cheirality) and start the refine rounds from
    # the argmax.  The single best draw's basin is wrong on a fraction
    # of seeds and no post-hoc vote rescues a bad R.  0 = single-start
    # cheirality vote.
    restart_k: int = 16
    # Probe refinement: the pre-refinement tight score is a weak
    # predictor of the post-refinement basin — on tail seeds the argmax
    # start converges to a local optimum while a slightly lower-scored
    # start reaches the global basin.  Instead of refining only the
    # argmax, probe-refine the best pose branch of each of the top
    # probe_starts E candidates with a short vmapped GN (probe_iters)
    # and START the full rounds from the post-probe argmax.  0/1
    # disables (argmax start).
    probe_starts: int = 8
    probe_iters: int = 6
    # Compact correspondences to this many slots before the geometry
    # program (valid entries first).  The keypoint capacity is
    # num_octaves * 2 * max_pts_per_octave slots (10240 in the bench
    # config) while a real pair yields ~1.2k matches, so RANSAC
    # scoring / triangulation over raw slots wastes ~8x of their
    # bandwidth.  0 disables (geometry runs at full capacity).
    geometry_cap: int = 2560
    # Correspondence subset for the FIRST cheirality vote (the one that
    # merely picks a branch + seeds refinement; the final vote and
    # triangulation always use every point).  Branch-picking is a 4-way
    # majority over inlier-weighted depths — a few hundred compacted
    # (valid-first) slots decide it identically while skipping ~75% of
    # the per-round recover_pose's 4xN DLT solves.  0 = all points.
    vote_cap: int = 512
