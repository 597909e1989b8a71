"""Camera trajectory evaluation: ATE and RPE with Sim(3) alignment.

Counterpart of ``gflow_tpu/eval/camera_eval.py`` (NumPy only, copied). The
reference shells out to the `evo` package (gflow/benchmark.py:289-394),
computing APE (translation, with alignment + scale correction) and RPE
(translation and rotation parts). evo is unavailable here, so this module
implements the standard definitions directly: Umeyama Sim(3) alignment of
the estimated trajectory to the reference, ATE RMSE over aligned positions,
and relative-pose errors between consecutive frames.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(gt_positions: np.ndarray, est_positions: np.ndarray,
             align=True, correct_scale=True) -> float:
    """Absolute trajectory error (RMSE) after optional Sim(3) alignment."""
    gt = np.asarray(gt_positions, np.float64)
    est = np.asarray(est_positions, np.float64)
    if align and len(gt) >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(gt - est, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def _rot_angle(R: np.ndarray) -> float:
    d = 0.5 * (np.trace(R) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def rpe(gt_poses: np.ndarray, est_poses: np.ndarray):
    """Relative pose error between consecutive frames.

    gt_poses, est_poses: (T, 4, 4) cam2world (or world2cam, consistently).
    Returns (rpe_trans_rmse, rpe_rot_rmse_deg).
    """
    gt = np.asarray(gt_poses, np.float64)
    est = np.asarray(est_poses, np.float64)
    t_errs, r_errs = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        est_rel = np.linalg.inv(est[i]) @ est[i + 1]
        err = np.linalg.inv(gt_rel) @ est_rel
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(_rot_angle(err[:3, :3]))
    if not t_errs:
        return 0.0, 0.0
    return (
        float(np.sqrt(np.mean(np.asarray(t_errs) ** 2))),
        float(np.degrees(np.sqrt(np.mean(np.asarray(r_errs) ** 2)))),
    )
