"""Video mask prior preparation: SAM 2 propagates the first frame's object
masks through the sequence, and per frame ``<seq>_mask/<name>.png``
(0/255) is the union of the objects' masks, the file ``fit_video`` reads
(``core/io.py`` ``list_sequence_files``).

The first frame's objects come from ``annotation``, a DAVIS 2017-style
palette PNG in which each nonzero index is an object, or without one from
``<seq>_epipolar/<frame 0>_open.png`` (``prep_moveseg``'s output) as one
object. Per sequence, all objects run as one batch:

1. each frame is encoded once (``Sam2Model.encode``: resized to 1024
   square on the card, normalized, Hiera, the FPN neck);
2. frame 0 takes its masks as the output (``Sam2Model.prompt``); every
   later frame's features are conditioned on the memory bank
   (``condition``, the memory attention), decoded (``heads``: the best of
   three masks, the object score, the object pointer) and written;
3. each frame's mask is encoded into a memory (``encode_memory``) and
   stored, with its object pointer, in the bank (``MemoryBank``: the
   prompted frame and the last 6 frames' memories, the last 16 pointers);
4. the written mask is the union of the objects' low-resolution logits
   resized to the frame (bilinear) and > 0.

The weights are a released SAM 2 ``.pt`` (``--checkpoint`` or
``$GFLOW_SAM2_WEIGHTS``); without them it raises ``FileNotFoundError``.
On the card each part replays a CUDA graph (``TRACK_GRAPHS``: one per
model, part and input shapes): the encoder one a frame shape, the memory
attention one per fill of the bank (its inputs are the bank's first n
memories and P pointers), so that every frame with a full bank, from frame
16 on, replays one graph; the decode and the memory encoder one each. CLI:
``python -m gflow_tpu_torch.cli.prep_track``.

``main`` records into the process's telemetry (``utils.profiling.current``)
the phase ``prep_track`` and its pieces ``prep_track/load`` (the frame read
and sent to the card) and ``prep_track/write`` (after the frame's device
work, the union read back and the PNG); the device seconds of
``track/encode``, ``track/memattn``, ``track/decode`` (the heads and the
union at the frame's size) and ``track/memenc``, from stamps on the card's
timer (``ops/stamp.py``); and the counters ``track/objects``,
``track/memory_frames`` (memories attended), ``track/ptr_tokens`` (pointer
tokens attended) and ``track/obj_present`` (object scores > 0), each
summed over frames.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.io import imread, imwrite
from ..models.sam2 import MemoryBank, Sam2Model, attended, convert, video_masks
from ..ops.stamp import stamp
from ..opt import graphs
from ..utils import profiling
from ..viz.colormap import print_color
from .prep_flow import list_frames

CKPT_ENV = "GFLOW_SAM2_WEIGHTS"
# the parts' graphs: one per model, part, static arguments and input shapes
# (the memory attention's one per fill of the bank, at most 16 fills)
TRACK_GRAPHS = graphs.ForwardCache("sam2", 32)
STAMPS = ("encode", "memattn", "decode", "memenc")  # between consecutive columns


def load_weights(path=None) -> dict | None:
    """The released-key state dict from `path` or $GFLOW_SAM2_WEIGHTS; None
    when there is none."""
    path = path or os.environ.get(CKPT_ENV)
    if not path or not os.path.exists(path):
        return None
    return convert.load_weights(path)


def read_objects(path, binary: bool = False) -> np.ndarray:
    """(O, H, W) bool masks of the objects of a palette PNG, one per
    nonzero index in increasing order; with `binary` a 0/255 mask as one
    object (> 127)."""
    from PIL import Image

    with Image.open(path) as img:
        a = np.asarray(img)
    if a.ndim != 2:
        raise ValueError(f"{path}: an annotation is a single-channel (palette) PNG")
    if binary:
        return (a > 127)[None]
    ids = [i for i in np.unique(a) if i != 0]
    if not ids:
        raise ValueError(f"{path}: no object in the annotation")
    return np.stack([a == i for i in ids])


def first_masks(img_dir: str, first: str, annotation: Optional[str]) -> np.ndarray:
    if annotation:
        return read_objects(annotation)
    path = os.path.join(img_dir + "_epipolar", f"{first}_open.png")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: pass --annotation or run prep_moveseg first")
    return read_objects(path, binary=True)


def _key(model, *static):
    return (graphs.module_key(model),) + static


def encode(model, frame, dev):
    """(feat_s0, feat_s1, feat) of `frame` (H, W, 3) uint8."""
    return TRACK_GRAPHS(_key(model, "encode"), model.encode, {"frame": frame}, dev)


def prompt(model, feat, feat_s0, feat_s1, objects, dev):
    """The prompted frame: objects (O, H, W) bool at the frame's size ->
    (low-res logits, pointers, object scores, the memory encoder's mask,
    the union (H, W) bool)."""
    S = model.config.image_size

    def fn(feat, feat_s0, feat_s1, objects):
        m = F.interpolate(objects[:, None].float(), (S, S), mode="bilinear",
                          align_corners=False, antialias=True)
        low, ptr, score, mem_mask = model.prompt(feat, feat_s0, feat_s1, (m >= 0.5).float())
        return low, ptr, score, mem_mask, (video_masks(low, objects.shape[1:]) > 0).any(0)

    return TRACK_GRAPHS(_key(model, "prompt"), fn, {"feat": feat, "feat_s0": feat_s0,
                                                    "feat_s1": feat_s1, "objects": objects}, dev)


def memattn(model, feat, memory, tpos, ptrs, ptr_pos, span: int, dev):
    """The memory-conditioned features (O, C, h, w); the graph's key holds
    the bank's fill through the shapes of memory and ptrs."""
    def fn(feat, memory, tpos, ptrs, ptr_pos):
        return model.condition(feat, memory, tpos, ptrs, ptr_pos, span)

    return TRACK_GRAPHS(_key(model, "memattn", span), fn,
                        {"feat": feat, "memory": memory, "tpos": tpos, "ptrs": ptrs,
                         "ptr_pos": ptr_pos}, dev)


def decode(model, cond, feat_s0, feat_s1, hw, dev):
    """A tracked frame's heads and the union at the frame's size hw: (all
    masks, IoUs, object scores, chosen low-res logits, pointers, chosen
    logits at 1024, union (H, W) bool)."""
    def fn(cond, feat_s0, feat_s1):
        out = model.heads(cond, feat_s0, feat_s1)
        return out + ((video_masks(out[3], hw) > 0).any(0),)

    return TRACK_GRAPHS(_key(model, "decode", tuple(hw)), fn,
                        {"cond": cond, "feat_s0": feat_s0, "feat_s1": feat_s1}, dev)


def memenc(model, feat, high, score, binarize: bool, dev):
    """The frame's memory (O, h*w, mem_dim)."""
    def fn(feat, high, score):
        return model.encode_memory(feat, high, score, binarize)

    return TRACK_GRAPHS(_key(model, "memenc", binarize), fn,
                        {"feat": feat, "high": high, "score": score}, dev)


def main(img_dir: str, checkpoint: Optional[str] = None, annotation: Optional[str] = None,
         device: Optional[str] = None, model=None, params=None):
    """model (a Sam2Model with its weights) or params (a released-key
    state dict) are injectable, as in the other prep stages."""
    with profiling.current().phase("prep_track"):
        return _main(img_dir, checkpoint, annotation, device, model, params)


def _main(img_dir, checkpoint, annotation, device, model, params):
    tel = profiling.current()
    phase = tel.phase
    if model is None:
        if params is None:
            params = load_weights(checkpoint)
        if params is None:
            raise FileNotFoundError(
                "no SAM 2 checkpoint: pass --checkpoint or set "
                f"${CKPT_ENV} to a released .pt (sam2.1_hiera_large.pt)")
        model = Sam2Model(convert.config_for_state_dict(params))
    if params is not None:
        model.load_state_dict(params, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    c = model.config

    img_dir = str(img_dir)
    out_dir = img_dir + "_mask"
    os.makedirs(out_dir, exist_ok=True)
    paths = list_frames(img_dir)
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    objects = first_masks(img_dir, names[0], annotation)
    O = len(objects)
    bank = MemoryBank(c, O, c.grid, len(paths), dev)
    row = torch.zeros(1, dtype=torch.int64, device=dev)
    for f, (path, name) in enumerate(zip(paths, names)):
        with phase("prep_track/load"):
            frame = torch.from_numpy(np.array(imread(path)[..., :3])).to(dev)
        hw = tuple(frame.shape[:2])
        if f == 0 and objects.shape[1:] != hw:
            raise ValueError(f"the first frame's objects are {objects.shape[1:]}, the frame {hw}")
        table = torch.zeros((1, len(STAMPS) + 1), dtype=torch.int64, device=dev)
        with torch.inference_mode():
            stamp(row, table, 0)
            feat_s0, feat_s1, feat = encode(model, frame, dev)
            stamp(row, table, 1)
            if f == 0:
                stamp(row, table, 2)
                low, ptr, score, high, union = prompt(
                    model, feat, feat_s0, feat_s1, torch.from_numpy(objects).to(dev), dev)
                stamp(row, table, 3)
                mem = memenc(model, feat, high, score, True, dev)
                sel = None
            else:
                sel = bank.select(f)
                cond = memattn(model, feat, bank.memory(sel), torch.from_numpy(sel["tpos"]),
                               bank.pointers(sel), torch.from_numpy(sel["ptr_pos"]),
                               bank.ptr_span, dev)
                stamp(row, table, 2)
                _, _, score, low, ptr, high, union = decode(model, cond, feat_s0, feat_s1, hw,
                                                            dev)
                stamp(row, table, 3)
                mem = memenc(model, feat, high, score, False, dev)
            stamp(row, table, 4)
            bank.store(f, mem, ptr)
            present = (score > 0).sum()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the frame's device work, outside the host phases
        with phase("prep_track/write"):
            imwrite(os.path.join(out_dir, f"{name}.png"),
                    union.cpu().numpy().astype(np.uint8) * 255)
        t = np.diff(table.cpu().numpy()[0]) * 1e-9
        for part, s in zip(STAMPS, t.tolist()):
            if part != "memattn" or sel is not None:
                tel.add("track/" + part, s)
        counts = {"objects": O, "obj_present": int(present),
                  "memory_frames": 0 if sel is None else sel["n"],
                  "ptr_tokens": 0 if sel is None else sel["P"] * (c.d_model // c.mem_dim)}
        for k, v in counts.items():
            tel.count("track/" + k, v)
        note = "prompted" if sel is None else str(attended(sel))
        print_color(f"[sam2] {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items())
                    + f"; {note}")
    return out_dir
