"""Reconstruction quality metrics: similarity alignment, ATE, RPE.

NO reference counterpart — the reference publishes only qualitative
screenshots (README.md:41-52).  These implement the driver's
north-star quality metrics: absolute trajectory error after similarity
(Sim(3)) alignment, relative pose error, and reprojection statistics.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale=True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: [N, 3] paired points (e.g. estimated vs GT camera
        centers).

    Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-18))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def camera_centers(R, t):
    """World-space camera centers C = -R^T t for [M, 3, 3], [M, 3]."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    return -np.einsum("mji,mj->mi", R, t)


def ate_rmse(R_est, t_est, R_gt, t_gt, with_scale=True):
    """Absolute trajectory error (RMSE of camera centers) after
    similarity alignment.  Scale-invariant by default (monocular SfM
    has a free global scale)."""
    c_est = camera_centers(R_est, t_est)
    c_gt = camera_centers(R_gt, t_gt)
    s, R, t = umeyama_alignment(c_est, c_gt, with_scale=with_scale)
    aligned = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(aligned - c_gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), err


def rotation_errors_deg(R_est, R_gt):
    """Per-camera geodesic rotation errors in degrees, after removing
    the best global rotation offset."""
    R_est = np.asarray(R_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    # Global alignment: average relative rotation via quaternion mean is
    # overkill; use the first camera as anchor.
    R0 = R_gt[0].T @ R_est[0]
    errs = []
    for i in range(R_est.shape[0]):
        dR = R_gt[i].T @ R_est[i] @ R0.T
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(c)))
    return np.asarray(errs)


def rpe_rmse(R_est, t_est, R_gt, t_gt):
    """Relative pose error between consecutive frames: (rot deg,
    translation-direction deg) RMSE.  Both are taken in the cameras'
    own frames, so they do not depend on the choice of world frame or
    scale."""
    R_est = np.asarray(R_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    t_est = np.asarray(t_est, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    rot_e, dir_e = [], []
    for i in range(1, R_est.shape[0]):
        dR_e = R_est[i] @ R_est[i - 1].T
        dR_g = R_gt[i] @ R_gt[i - 1].T
        dd = dR_g.T @ dR_e
        c = np.clip((np.trace(dd) - 1) / 2, -1, 1)
        rot_e.append(np.degrees(np.arccos(c)))
        v_e = t_est[i] - dR_e @ t_est[i - 1]
        v_g = t_gt[i] - dR_g @ t_gt[i - 1]
        ne, ng = np.linalg.norm(v_e), np.linalg.norm(v_g)
        if ne > 1e-12 and ng > 1e-12:
            cc = np.clip(abs(v_e @ v_g) / (ne * ng), -1, 1)
            dir_e.append(np.degrees(np.arccos(cc)))
    rot = float(np.sqrt(np.mean(np.square(rot_e)))) if rot_e else 0.0
    tr = float(np.sqrt(np.mean(np.square(dir_e)))) if dir_e else 0.0
    return rot, tr
