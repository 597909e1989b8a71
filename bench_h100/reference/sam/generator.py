"""SAM's automatic mask generator (``segment_anything/
automatic_mask_generator.py`` and ``utils/amg.py`` at its defaults,
``crop_n_layers`` 0) written plainly, and the union GFlow's mask prior
writes: on one frame, from the low-resolution logits and predicted IoUs
of every prompt of the grid.

Departures, each also the program's: NMS ties are broken by the prompt's
order (torchvision sorts without a stated order); the written mask is the
union of the masks left that lie at least ``union_share`` inside the
frame's moving-object mask (GFlow's glue, the configuration's
``assumed``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import input_size


def grid_points(n: int, frame_hw, image_size: int) -> np.ndarray:
    """(n * n, 2) float64 (x, y) prompts in pixels of the resized frame
    (``build_point_grid``, scaled to the frame, then ``apply_coords``)."""
    H, W = frame_hw
    offset = 1 / (2 * n)
    side = np.linspace(offset, 1 - offset, n)
    xs = np.tile(side[None, :], (n, 1))
    ys = np.tile(side[:, None], (1, n))
    pts = np.stack([xs, ys], axis=-1).reshape(-1, 2) * np.array(frame_hw)[None, ::-1]
    h, w = input_size(H, W, image_size)
    out = pts.copy()
    out[:, 0] = out[:, 0] * (w / W)
    out[:, 1] = out[:, 1] * (h / H)
    return out


def postprocess(low, frame_hw, image_size: int):
    """Logits (B, M, 4g, 4g) -> (B, M, H, W) (``Sam.postprocess_masks``)."""
    h, w = input_size(frame_hw[0], frame_hw[1], image_size)
    m = F.interpolate(low, (image_size, image_size), mode="bilinear", align_corners=False)
    m = m[..., :h, :w]
    return F.interpolate(m, tuple(frame_hw), mode="bilinear", align_corners=False)


def stability(logits, offset: float):
    """IoU of the masks at +offset and -offset (``calculate_stability_score``)."""
    inter = (logits > offset).sum(-1, dtype=torch.int64).sum(-1)
    union = (logits > -offset).sum(-1, dtype=torch.int64).sum(-1)
    return inter / union


def box(mask: np.ndarray):
    """XYXY inclusive bounds of a bool (H, W) mask; zeros when empty."""
    ys, xs = np.nonzero(mask)
    if not len(ys):
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)


def box_iou(a, b):
    """torchvision's IoU of box a (4,) with boxes b (M, 4): areas (x2 -
    x1) (y2 - y1); NaN for 0 / 0."""
    w = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    h = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = w * h
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / union


def nms(boxes, scores, thresh: float) -> list:
    """Greedy NMS: in descending score (ties by index) a box is kept when
    no kept box overlaps it by an IoU above `thresh`."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    order = sorted(range(len(scores)), key=lambda i: (-float(scores[i]), i))
    kept = []
    for i in order:
        if not (box_iou(boxes[i], boxes[kept]) > thresh).any():
            kept.append(i)
    return kept


def select(low, iou, frame_hw, inside, g: dict):
    """One frame's union mask and the logit that decides each of its
    pixels. low (P, 3, 4g, 4g), iou (P, 3) of the frame's P prompts in
    grid order; inside (H, W) bool; g the generator's settings
    (``pred_iou_thresh``, ``stability_score_thresh``,
    ``stability_score_offset``, ``box_nms_thresh``, ``union_share``,
    ``image_size``). Returns (union (H, W) bool, logit (H, W): the largest
    logit of the union's masks, -inf where it has none; counts, with
    ``nms_kept`` the masks NMS kept, by index prompt * 3 + output)."""
    S = g["image_size"]
    logits, preds, ids = [], [], []
    for b in range(0, low.shape[0], 64):
        m = postprocess(low[b:b + 64], frame_hw, S).flatten(0, 1)
        p = iou[b:b + 64].flatten()
        keep = p > g["pred_iou_thresh"]
        keep &= stability(m, g["stability_score_offset"]) >= g["stability_score_thresh"]
        logits.append(m[keep])
        preds.append(p[keep])
        ids += (torch.nonzero(keep)[:, 0] + 3 * b).tolist()
    logits, preds = torch.cat(logits), torch.cat(preds)
    masks = (logits > 0).cpu().numpy()
    kept = nms([box(m) for m in masks], preds.cpu().numpy(), g["box_nms_thresh"])
    inside = np.asarray(inside, bool)
    area = masks.sum((1, 2))
    within = (masks & inside).sum((1, 2))
    chosen = [i for i in kept if area[i] > 0 and within[i] >= g["union_share"] * area[i]]
    union = np.zeros(frame_hw, bool)
    best = torch.full(tuple(frame_hw), -np.inf, device=logits.device)
    for i in chosen:
        union |= masks[i]
        best = torch.maximum(best, logits[i])
    counts = {"kept_stability": len(masks), "kept_nms": len(kept), "kept_union": len(chosen),
              "nms_kept": sorted(ids[i] for i in kept)}
    return union, best.cpu().numpy(), counts
