"""Intermediate-value dump + pretty printers: the parity surface.

Equivalent of the reference's `enable_debug` harness
(reference SfM/kernels.h:19 gates printVector/printMatrix/print3DSlice
at :34-97; the stages dump U/X, per-hypothesis A and E candidates,
inlier counts, the 4 candidate poses, the chosen P, and triangulated
points at SfM/sfm.cu:86-91, 130-141, 268-298, 325-336).  SURVEY.md §4
identifies those print points as the de-facto expected-intermediate-
values contract; this module reproduces the same surface as a pytree
of named arrays, computed by the SAME jitted building blocks the
production pipeline uses (identical PRNG key -> bit-identical RANSAC
bank).

Usage:
    from sfm_jax.utils import debug
    d = debug.two_view_dump(img1, img2, K, key, cfg)
    debug.print_dump(d)          # reference-style formatted print
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from sfm_jax.config import PipelineConfig
from sfm_jax.geometry import camera, epipolar, pose, ransac, triangulate as tri
from sfm_jax.models import two_view
from sfm_jax.sift import frontend


def two_view_dump(img1, img2, K, key, cfg: PipelineConfig = PipelineConfig(),
                  *, max_hyps: int = 16, max_pts: int = 16) -> dict:
    """Run the two-view pipeline and collect every debug-print surface.

    Heads (first `max_hyps` / `max_pts` entries) of the large arrays
    are returned under `*_head` keys for printing; the full arrays stay
    available under their own names.
    """
    s1 = frontend.extract_sift(img1, cfg.sift)
    s2 = frontend.extract_sift(img2, cfg.sift)
    uv1, uv2, mask = two_view._match_stage(s1, s2, cfg)

    K = jnp.asarray(K)
    K_inv = camera.inv_intrinsics(K)
    # Reference fillXU: U = 3xN homogeneous pixels, X = K^-1 U
    # (SfM/sfm.cu:80-92; debug prints at :86-91).
    U1 = camera.to_homogeneous(uv1)
    U2 = camera.to_homogeneous(uv2)
    x1 = camera.normalize_points(uv1, K_inv)
    x2 = camera.normalize_points(uv2, K_inv)

    rc = cfg.ransac
    disparity_ok = (
        jnp.sum((uv1 - uv2) ** 2, axis=-1) > rc.min_disparity_px ** 2
    )
    est_mask = mask & disparity_ok
    # Same key + same helper as ransac_essential -> identical bank.
    E_bank, min_idx, A, T1, T2 = ransac.build_hypothesis_bank(
        key, x1, x2, est_mask, n_hyps=rc.n_hyps, sweeps=rc.sweeps
    )
    res = ransac.ransac_essential(
        key, x1, x2, est_mask,
        n_hyps=rc.n_hyps, threshold=rc.threshold, chunk=rc.chunk,
        sweeps=rc.sweeps, refit_iters=rc.refit_iters,
    )
    # 4 candidate poses + cheirality votes (SfM/sfm.cu:238-307).
    Rs, ts = pose.pose_candidates(res.E)
    p = pose.recover_pose(res.E, x1, x2, weights=res.inliers.astype(x1.dtype))
    full = two_view.two_view_geometry(key, uv1, uv2, mask, K, cfg)
    X_h = tri.dlt_system  # noqa: F841  (kept import-referenced)

    d = {
        "num_kp1": jnp.sum(s1.keypoints.valid),
        "num_kp2": jnp.sum(s2.keypoints.valid),
        "num_matches": full.num_matches,
        "U1": U1, "U2": U2, "X1": x1, "X2": x2, "corr_mask": mask,
        "A": A, "minimal_idx": min_idx,
        "hartley_T1": T1, "hartley_T2": T2,
        "E_bank": E_bank,
        "inlier_counts": res.counts,
        "best_index": res.best_index,
        "E_best": res.E,
        "R_candidates": Rs, "t_candidates": ts,
        "cheirality_votes": p["votes"],
        "chosen_candidate": p["index"],
        "P_chosen": tri.make_projection(full.R, full.t),
        "R": full.R, "t": full.t,
        "points": full.points, "point_valid": full.point_valid,
        "num_inliers": full.num_inliers,
        "reproj_err": full.reproj_err,
    }
    d["E_bank_head"] = E_bank[:max_hyps]
    d["inlier_counts_head"] = res.counts[:max_hyps]
    d["A0"] = A[0]
    d["U1_head"] = U1[:max_pts]
    d["X1_head"] = x1[:max_pts]
    d["points_head"] = full.points[:max_pts]
    return jax.tree_util.tree_map(np.asarray, d)


def print_matrix(name: str, a, file=None):
    """Reference printMatrix-style output (SfM/kernels.h:59-74)."""
    a = np.asarray(a)
    file = file or sys.stdout
    print(f"{name} [{'x'.join(map(str, a.shape))}]:", file=file)
    with np.printoptions(precision=6, suppress=True, linewidth=120,
                         threshold=64, edgeitems=4):
        print(a, file=file)


def print_dump(d: dict, file=None):
    """Formatted dump mirroring the reference's enable_debug order."""
    file = file or sys.stdout
    scalars = [
        "num_kp1", "num_kp2", "num_matches", "best_index",
        "chosen_candidate", "num_inliers", "reproj_err",
    ]
    for k in scalars:
        print(f"{k} = {d[k]}", file=file)
    for k in [
        "U1_head", "X1_head", "hartley_T1", "A0", "E_bank_head",
        "inlier_counts_head", "E_best", "R_candidates", "t_candidates",
        "cheirality_votes", "P_chosen", "points_head",
    ]:
        print_matrix(k, d[k], file=file)
