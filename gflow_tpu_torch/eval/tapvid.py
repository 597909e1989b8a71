"""TAP-Vid point-tracking metrics.

Counterpart of ``gflow_tpu/eval/tapvid.py`` (NumPy only, copied). Implements the metric definitions of the TAP-Vid benchmark (Doersch et al.,
NeurIPS 2022) used by the reference's tracking evaluation
(gflow/utils/tapvid.py:23-167, gflow/benchmark.py:168-172):

- occlusion_accuracy: fraction of correctly predicted visibilities,
- pts_within_{1,2,4,8,16}: among ground-truth-visible points, fraction of
  predictions within the pixel threshold (256x256 resolution convention),
- jaccard_{t}: true positives (visible, within t, predicted visible) over
  (true positives + false negatives + false positives),
- average_jaccard / average_pts_within_thresh: means over thresholds.

Query modes:
- "first": evaluate only frames strictly after the query frame,
- "strided": evaluate all frames except the query frame itself.
"""
from __future__ import annotations

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)


def compute_tapvid_metrics(
    query_points: np.ndarray,  # (B, Q, 3)  [t, y, x] in 256x256 coords
    gt_occluded: np.ndarray,   # (B, Q, T) bool
    gt_tracks: np.ndarray,     # (B, Q, T, 2)  [x, y] in 256x256 coords
    pred_occluded: np.ndarray, # (B, Q, T) bool
    pred_tracks: np.ndarray,   # (B, Q, T, 2)
    query_mode: str = "strided",
):
    """Returns a dict of scalar metrics (percent values like the benchmark)."""
    gt_occluded = np.asarray(gt_occluded, bool)
    pred_occluded = np.asarray(pred_occluded, bool)
    gt_tracks = np.asarray(gt_tracks, np.float64)
    pred_tracks = np.asarray(pred_tracks, np.float64)
    B, Q, T = gt_occluded.shape

    t_idx = np.arange(T)[None, None, :]
    q_frame = np.asarray(query_points)[..., 0][..., None]  # (B, Q, 1)
    if query_mode == "first":
        eval_mask = t_idx > q_frame
    elif query_mode == "strided":
        eval_mask = t_idx != q_frame
    else:
        raise ValueError(f"unknown query_mode {query_mode}")

    gt_visible = ~gt_occluded
    pred_visible = ~pred_occluded

    out = {}
    correct_occ = (pred_occluded == gt_occluded) & eval_mask
    out["occlusion_accuracy"] = 100.0 * correct_occ.sum() / eval_mask.sum()

    dist = np.linalg.norm(pred_tracks - gt_tracks, axis=-1)  # (B, Q, T)

    pts_list, jac_list = [], []
    for thr in THRESHOLDS:
        within = dist < thr
        vis_eval = gt_visible & eval_mask
        n_vis = vis_eval.sum()
        frac = 100.0 * (within & vis_eval).sum() / max(n_vis, 1)
        out[f"pts_within_{thr}"] = frac
        pts_list.append(frac)

        tp = (within & gt_visible & pred_visible & eval_mask).sum()
        fn = (gt_visible & eval_mask & ~(within & pred_visible)).sum()
        fp = (pred_visible & eval_mask & ~(gt_visible & within)).sum()
        jac = 100.0 * tp / max(tp + fn + fp, 1)
        out[f"jaccard_{thr}"] = jac
        jac_list.append(jac)

    out["average_pts_within_thresh"] = float(np.mean(pts_list))
    out["average_jaccard"] = float(np.mean(jac_list))
    return out
