"""DAVIS segmentation measures: region similarity J and boundary F.

Counterpart of ``gflow_tpu/eval/davis.py`` (NumPy and SciPy, copied). Same
definitions as the official DAVIS toolkit used by the reference
(gflow/utils/measures/jaccard.py, f_boundary.py): J is the IoU of binary
masks; F is the F-measure between morphologically-dilated boundary maps
(dilation radius 0.8% of the image diagonal).

skimage is unavailable here; boundary extraction and binary dilation use
numpy/scipy directly.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation


def jaccard_iou(seg: np.ndarray, gt: np.ndarray) -> float:
    """J: intersection-over-union; defined as 1 for two empty masks."""
    seg = np.asarray(seg, bool)
    gt = np.asarray(gt, bool)
    union = (seg | gt).sum()
    if union == 0:
        return 1.0
    return float((seg & gt).sum() / union)


def _boundary_map(mask: np.ndarray) -> np.ndarray:
    """Binary boundary of a mask: pixels whose 4-neighbourhood leaves the
    mask (equivalent surface to the toolkit's seg2bmap)."""
    m = np.asarray(mask, bool)
    if not m.any():
        return np.zeros_like(m)
    pad = np.pad(m, 1, mode="edge")
    interior = (
        pad[1:-1, :-2] & pad[1:-1, 2:] & pad[:-2, 1:-1] & pad[2:, 1:-1]
    )
    return m & ~interior


def boundary_f_measure(seg: np.ndarray, gt: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """F: precision/recall harmonic mean between dilated boundaries."""
    seg = np.asarray(seg, bool)
    gt = np.asarray(gt, bool)
    fg = _boundary_map(seg)
    gb = _boundary_map(gt)

    diag = np.sqrt(seg.shape[0] ** 2 + seg.shape[1] ** 2)
    radius = max(1, int(np.ceil(bound_th * diag)))
    yy, xx = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    disk = (xx * xx + yy * yy) <= radius * radius

    fg_dil = binary_dilation(fg, structure=disk)
    gb_dil = binary_dilation(gb, structure=disk)

    n_fg = fg.sum()
    n_gt = gb.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = (fg & gb_dil).sum() / n_fg
    recall = (gb & fg_dil).sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))
