"""Mask prior preparation: Segment Anything's automatic mask generator
(``SamAutomaticMaskGenerator`` at its defaults, ``crop_n_layers`` 0) over
every frame, and per frame ``<seq>_mask/<name>.png`` (0/255), the mask of
the moving object that ``fit_video`` reads (``core/io.py``
``list_sequence_files``; the trainer's ``init_mask_prompt_pts``).

Per frame:

1. the frame is encoded once (``SamModel.encode``: resized so that its
   longer side is 1024, normalized, padded, the ViT);
2. SAM's automatic grid of 32 x 32 positive points at ((i + 0.5) / 32 *
   W, (j + 0.5) / 32 * H) is decoded 64 at a time, three masks a point
   (multimask);
3. each batch's logits go to the frame's size (``postprocess_masks``);
   a mask is kept where its predicted IoU > 0.88 and its stability,
   count(logit > 1) / count(logit > -1), is >= 0.95; masks are binarized
   at 0;
4. box NMS at 0.7 over the frame's kept masks, scored by the predicted
   IoU (torchvision's ``batched_nms`` semantics in plain torch, ties in
   the order of the prompts);
5. the written mask is the union of the masks left that lie at least
   half inside the frame's moving-object mask
   ``<seq>_epipolar/<name>_open.png`` (``prep_moveseg``'s output, which
   must exist): the glue between SAM's masks and GFlow's one object mask.

The numbers above are ``GENERATOR``, the settings ``main``'s `generator`
overrides by the names of ``SamAutomaticMaskGenerator``'s arguments.

The weights are a released SAM ``.pth`` (``--checkpoint`` or
``$GFLOW_SAM_WEIGHTS``); without them it raises ``FileNotFoundError``.
On the card the encoder and each batch's decode (prompt encoder and mask
decoder) replay CUDA graphs (``MASK_GRAPHS``: one per model, input shapes
and device); the post-processing and the selection, whose shapes depend
on the data, run eagerly on the card. CLI: ``python -m
gflow_tpu_torch.cli.prep_mask``.

``main`` records into the process's telemetry (``utils.profiling.current``)
the phase ``prep_mask`` and its pieces ``prep_mask/load`` (the frame and
its moving-object mask read and sent to the card), ``prep_mask/select``
(the kept masks gathered, NMS and the union, after the frame's device work
has ended) and ``prep_mask/write`` (the PNG); the device seconds
of ``mask/encode``, ``mask/decode`` (the batches' graph replays) and
``mask/post`` (their logits to the frame's size, stability and binarize),
from stamps on the card's timer (``ops/stamp.py``); and the counters
``mask/prompts``, ``mask/kept_iou``, ``mask/kept_stability`` (kept by
both filters), ``mask/kept_nms``, ``mask/kept_union`` and
``mask/decoder_fused_batches``: the batches whose decode ran the
decoder's image stream through its kernels (``ops/sam_decoder.py``; one
``sam_stream_init`` launch a batch, 0 on the CPU).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.io import imread, imwrite
from ..models.sam import SamModel, convert, input_size, postprocess_masks
from ..ops import _build
from ..ops.stamp import stamp
from ..opt import graphs
from ..utils import profiling
from ..viz.colormap import print_color
from .prep_flow import list_frames

CKPT_ENV = "GFLOW_SAM_WEIGHTS"
# SamAutomaticMaskGenerator's defaults (no crops, no small-region removal:
# the only values taken for those two), and the share of a mask inside the
# moving-object mask that puts it into the union
GENERATOR = {"points_per_side": 32, "points_per_batch": 64, "pred_iou_thresh": 0.88,
             "stability_score_thresh": 0.95, "stability_score_offset": 1.0,
             "box_nms_thresh": 0.7, "crop_n_layers": 0, "min_mask_region_area": 0,
             "union_share": 0.5}
# the encoder's and the decode's graphs: one per model, input shapes and device
MASK_GRAPHS = graphs.ForwardCache("sam", 8)


def load_weights(path=None) -> dict | None:
    """The released-key state dict from `path` or $GFLOW_SAM_WEIGHTS; None
    when there is none."""
    path = path or os.environ.get(CKPT_ENV)
    if not path or not os.path.exists(path):
        return None
    return convert.load_weights(path)


def point_grid(n: int, h: int, w: int) -> np.ndarray:
    """(n * n, 2) float64 (x, y) pixels of the frame: SAM's
    ``build_point_grid`` (cell centres, x fastest) times (w, h)."""
    side = (np.arange(n) + 0.5) / n
    xy = np.stack([np.tile(side[None, :], (n, 1)), np.tile(side[:, None], (1, n))], -1)
    return xy.reshape(-1, 2) * np.array([w, h], np.float64)


def encode(model, frame, dev):
    """The image embedding of `frame` (H, W, 3) uint8 on `dev`."""
    return MASK_GRAPHS((graphs.module_key(model), "encode"), model.encode,
                       {"frame": frame}, dev)


def decode(model, embedding, points, dev):
    """(low-res logits (B, 3, 4g, 4g), IoUs (B, 3)) of B positive points
    (B, 2) in pixels of the resized frame."""
    labels = torch.ones(points.shape[0], 1, dtype=torch.int64, device=points.device)
    return MASK_GRAPHS((graphs.module_key(model), "decode"), model.decode,
                       {"embedding": embedding, "points": points[:, None], "labels": labels},
                       dev)


def settings(generator: Optional[dict] = None) -> dict:
    """``GENERATOR`` with `generator`'s values; a name it does not have,
    or crops or small-region removal asked for, raise ``ValueError``."""
    g = dict(GENERATOR, **(generator or {}))
    if g.keys() != GENERATOR.keys():
        raise ValueError(f"unknown generator settings {sorted(g.keys() - GENERATOR.keys())}")
    if g["crop_n_layers"] or g["min_mask_region_area"]:
        raise ValueError("crop_n_layers and min_mask_region_area other than 0 are not supported")
    return g


def post(low, iou, in_hw, frame_hw, image_size: int, out, g=GENERATOR):
    """A batch's masks at the frame's size, binarized into `out` (B * 3,
    H, W) bool; returns (kept by IoU, kept by IoU and stability), (B * 3,)
    bool each, at the generator settings `g`."""
    logits = postprocess_masks(low, in_hw, frame_hw, image_size).flatten(0, 1)
    inter = (logits > g["stability_score_offset"]).sum((-1, -2))
    union = (logits > -g["stability_score_offset"]).sum((-1, -2))
    kept_iou = iou.flatten() > g["pred_iou_thresh"]
    torch.gt(logits, 0.0, out=out)
    return kept_iou, kept_iou & (inter / union >= g["stability_score_thresh"])


def mask_boxes(masks):
    """(N, H, W) bool -> (N, 4) XYXY boxes, inclusive pixel bounds; 0 for
    an empty mask (SAM's ``batched_mask_to_box``)."""
    N, H, W = masks.shape
    rows, cols = masks.any(-1), masks.any(-2)
    ys = torch.arange(H, device=masks.device)
    xs = torch.arange(W, device=masks.device)
    bottom = (rows * ys).amax(-1)
    top = (rows * ys + H * ~rows).amin(-1)
    right = (cols * xs).amax(-1)
    left = (cols * xs + W * ~cols).amin(-1)
    out = torch.stack([left, top, right, bottom], -1)
    return out * ((right >= left) & (bottom >= top))[:, None]


def box_iou(a, b):
    """(N, 4) x (M, 4) XYXY -> (N, M) IoU, areas (x2 - x1) (y2 - y1) (as
    torchvision's ``box_iou``; 0 / 0 gives NaN, which suppresses
    nothing)."""
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def nms(boxes, scores, thresh: float):
    """Indices of the boxes greedy NMS keeps, in descending score (ties in
    index order): a box is dropped when its IoU with a kept box is above
    `thresh`."""
    order = torch.argsort(scores, descending=True, stable=True)
    over = (box_iou(boxes[order].float(), boxes[order].float()) > thresh).cpu().numpy()
    dropped = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if not dropped[i]:
            keep.append(i)
            dropped |= over[i]
    return order[torch.as_tensor(keep, dtype=torch.int64, device=order.device)]


def union_inside(masks, inside, share: float):
    """The union of the masks (N, H, W) that lie at least `share` inside
    `inside` (H, W), and how many did."""
    area = masks.sum((-1, -2))
    within = (masks & inside).sum((-1, -2))
    sel = (within >= share * area) & (area > 0)
    return masks[sel].any(0), int(sel.sum())


def select(masks, kept, iou, inside, g):
    """One frame's selection from its masks (N, H, W) bool, those the
    filters kept (N,) bool and their predicted IoUs (N,): NMS over the
    kept, then the union of those left that lie inside `inside`. Returns
    (union (H, W) bool, the indices into the N masks that NMS kept,
    {"kept_stability", "kept_nms", "kept_union"})."""
    idx = torch.nonzero(kept)[:, 0]
    chosen = masks[idx]
    keep = nms(mask_boxes(chosen), iou[idx], g["box_nms_thresh"])
    union, n_union = union_inside(chosen[keep], inside, g["union_share"])
    return union, idx[keep], {"kept_stability": len(idx), "kept_nms": len(keep),
                              "kept_union": n_union}


def main(img_dir: str, checkpoint: Optional[str] = None, device: Optional[str] = None,
         model=None, params=None, generator=None):
    """model (a SamModel with its weights) or params (a released-key state
    dict) are injectable, as in the other prep stages; generator (a dict)
    overrides ``GENERATOR``'s settings."""
    with profiling.current().phase("prep_mask"):
        return _main(img_dir, checkpoint, device, model, params, settings(generator))


def _main(img_dir, checkpoint, device, model, params, g):
    tel = profiling.current()
    phase = tel.phase
    if model is None:
        if params is None:
            params = load_weights(checkpoint)
        if params is None:
            raise FileNotFoundError(
                "no SAM checkpoint: pass --checkpoint or set "
                f"${CKPT_ENV} to a released .pth (sam_vit_h_4b8939.pth)")
        model = SamModel(convert.config_for_state_dict(params))
    if params is not None:
        model.load_state_dict(params, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    S = model.config.image_size

    img_dir = str(img_dir)
    out_dir = img_dir + "_mask"
    os.makedirs(out_dir, exist_ok=True)
    B = g["points_per_batch"]
    nb = -(-g["points_per_side"] ** 2 // B)
    grid = None
    for path in list_frames(img_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        with phase("prep_mask/load"):
            open_path = os.path.join(img_dir + "_epipolar", f"{name}_open.png")
            if not os.path.exists(open_path):
                raise FileNotFoundError(f"{open_path}: run prep_moveseg first")
            frame = torch.from_numpy(np.array(imread(path)[..., :3])).to(dev)
            inside = torch.from_numpy(np.asarray(imread(open_path)) > 127).to(dev)
        H, W = frame.shape[:2]
        in_hw = input_size(H, W, S)
        if grid is None or grid[0] != (H, W):
            pts = point_grid(g["points_per_side"], H, W) * np.array([in_hw[1] / W,
                                                                   in_hw[0] / H])
            grid = ((H, W), torch.from_numpy(pts).to(dev))
        pts = grid[1]
        # stamps: row 0 the encode (start, end), row 1 + b batch b's
        # decode (start, after the decode, after the post)
        table = torch.zeros((1 + nb, 3), dtype=torch.int64, device=dev)
        rows = torch.arange(1 + nb, device=dev)
        masks = torch.empty((len(pts) * 3, H, W), dtype=torch.bool, device=dev)
        iou_all = torch.empty(len(pts) * 3, device=dev)
        kept_iou = torch.empty(len(pts) * 3, dtype=torch.bool, device=dev)
        kept = torch.empty(len(pts) * 3, dtype=torch.bool, device=dev)
        fused = _build.LAUNCHES["sam_stream_init"]
        with torch.inference_mode():
            stamp(rows[:1], table, 0)
            emb = encode(model, frame, dev)
            stamp(rows[:1], table, 1)
            for b in range(nb):
                s = slice(3 * B * b, 3 * min(B * (b + 1), len(pts)))
                stamp(rows[1 + b:2 + b], table, 0)
                low, iou = decode(model, emb, pts[B * b:B * (b + 1)], dev)
                stamp(rows[1 + b:2 + b], table, 1)
                kept_iou[s], kept[s] = post(low, iou, in_hw, (H, W), S, masks[s], g)
                iou_all[s] = iou.flatten()
                stamp(rows[1 + b:2 + b], table, 2)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the frame's device work, outside the host phases
            with phase("prep_mask/select"):
                union, _, selected = select(masks, kept, iou_all, inside, g)
                out = union.cpu().numpy()
        with phase("prep_mask/write"):
            imwrite(os.path.join(out_dir, f"{name}.png"), out.astype(np.uint8) * 255)
        t = table.cpu().numpy()
        tel.add("mask/encode", float(t[0, 1] - t[0, 0]) * 1e-9)
        tel.add("mask/decode", float((t[1:, 1] - t[1:, 0]).sum()) * 1e-9, nb)
        tel.add("mask/post", float((t[1:, 2] - t[1:, 1]).sum()) * 1e-9, nb)
        counts = {"prompts": len(pts), "kept_iou": int(kept_iou.sum()), **selected,
                  "decoder_fused_batches": _build.LAUNCHES["sam_stream_init"] - fused}
        for k, v in counts.items():
            tel.count("mask/" + k, v)
        print_color(f"[sam] {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return out_dir
