"""Driver of the mask prior: the port's ``prep_mask.main`` (SAM's automatic
point grid over every frame, the masks in the moving-object mask joined
into ``<seq>_mask/<name>.png``) run on whole sequences, one after another,
as a user masks a video before fitting it, with SAM injected at the
configuration's widths and generator settings, its weights made on the
card from the seed, the reference given its own copy.

Set-up: one period of the benchmark's synthetic video with its priors
(``scene/sequence.py`` ``write_sequence``), cut to the configuration's
``sequence_frames`` and without its ``_mask`` file; the weights made; one
warm sequence masked, so that every graph the window replays is recorded.
The window masks whole sequences while the last one's duration says the
next ends inside it; at least one runs.

The check, on the window's last sequence: a tap on ``prep_mask``'s
``encode`` and ``decode`` keeps, for two frames drawn from the seed, the
image embedding, every batch's low-resolution logits and IoUs and the
prompts decoded, and a tap on ``prep_mask.select`` the masks NMS kept
there. The plain reference (``reference/sam``) computes the
embeddings of those frames and, from its own embeddings, the logits and
IoUs of two grid batches drawn from the seed; the generator's semantics
(``reference/sam/generator.py``: filters, NMS, union) applied to the
program's own logits of each drawn frame give the mask the program had to
write. Compared:

- ``embed_rel_gap``, ``logit_rel_gap``: largest absolute gap over the
  reference's largest absolute value; ``iou_gap``: largest absolute gap;
- ``mask_flip_share``: pixels of the written masks that differ from the
  reference's union, over the frames' pixels; pixels whose union logit
  lies within ``logit_rel_gap``'s limit of 0 (relative to the largest) do
  not count;
- ``nms_kept_mismatch``: masks (prompt and output) in one of the two sets
  NMS kept, the program's and the reference generator's, and not in the
  other, summed over the drawn frames;
- ``prompts_missing``: points of the reference's grid that no decode of
  the drawn frames was given (within 1e-3 px);
- ``mask_files_missing``: frames of the last sequence without a mask file
  of the frame's size written by that sequence.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np

from harness.counters import count_captures


class Prepared:
    pass


def weights(run):
    """The program's SAM and a copy of its state dict for the reference:
    seeded uniform weights in the released layout (``scene/weights.py``),
    each times the ``weight_scale`` of the longest of its keys (a part,
    ``image_encoder``, ``prompt_encoder``, ``mask_decoder``, or a module in
    one) that prefixes the weight's name, the Fourier features' Gaussian
    matrix drawn as the released model draws it (standard normal)."""
    import torch

    from gflow_tpu_torch.models.sam import SamConfig, SamModel
    from scene.weights import seeded_state_dict, shapes_of

    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in run.config["sam"].items()}
    with torch.device("meta"):
        model = SamModel(SamConfig(**cfg))
    seed = run.seed * 3 + 3
    sd = seeded_state_dict(shapes_of(model), seed, 1.0, run.device)
    scale = run.config["weight_scale"]
    for k, v in sd.items():
        v.mul_(scale[max((p for p in scale if k.startswith(p + ".")), key=len)])
    key = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    gen = torch.Generator(device=run.device).manual_seed((seed + 1) % 2 ** 63)
    sd[key] = torch.randn(sd[key].shape, generator=gen, device=run.device)
    copy = {k: v.clone() for k, v in sd.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(run.device).eval(), copy


def mask_sequence(s, run) -> None:
    from gflow_tpu_torch.pipeline import prep_mask

    with run.spans.span("prep_mask"):
        prep_mask.main(s.dir, device=run.device, model=s.model, generator=_generator(run))


class Tap:
    """While installed, keeps (cloned on the card) what ``prep_mask``'s
    ``encode`` and ``decode`` returned for the frames in `frames` (indices
    in the sequence), the points each decode was given and the indices of
    the masks ``select``'s NMS kept; ``clear`` starts a sequence."""

    def __init__(self, frames):
        self.frames = set(frames)
        self.clear()

    def clear(self) -> None:
        self.frame = -1
        self.kept = {}

    @contextlib.contextmanager
    def installed(self):
        from gflow_tpu_torch.pipeline import prep_mask

        enc, dec, sel = prep_mask.encode, prep_mask.decode, prep_mask.select

        def encode(model, frame, dev):
            out = enc(model, frame, dev)
            self.frame += 1
            if self.frame in self.frames:
                self.kept[self.frame] = {"embed": out.clone(), "low": [], "iou": [],
                                         "points": []}
            return out

        def decode(model, embedding, points, dev):
            low, iou = dec(model, embedding, points, dev)
            k = self.kept.get(self.frame)
            if k is not None:
                k["low"].append(low.clone())
                k["iou"].append(iou.clone())
                k["points"].append(points.clone())
            return low, iou

        def select(*a, **kw):
            union, nms_kept, counts = sel(*a, **kw)
            k = self.kept.get(self.frame)
            if k is not None:
                k["nms"] = nms_kept.clone()
            return union, nms_kept, counts

        prep_mask.encode, prep_mask.decode, prep_mask.select = encode, decode, select
        try:
            yield self
        finally:
            prep_mask.encode, prep_mask.decode, prep_mask.select = enc, dec, sel


def _drawn(run, frames: int) -> tuple:
    """The checked frames and grid batches, drawn from the seed."""
    g = run.config["generator"]
    batches = -(-g["points_per_side"] ** 2 // g["points_per_batch"])
    rng = np.random.default_rng(run.seed % 2 ** 63)
    f = sorted(rng.choice(frames, size=min(int(run.config["check_frames"]), frames),
                          replace=False).tolist())
    b = sorted(rng.choice(batches, size=min(int(run.config["check_batches"]), batches),
                          replace=False).tolist())
    return f, b


def setup(run):
    import torch

    from scene.sequence import Sequence, write_sequence

    s = Prepared()
    s.frames = int(run.config["sequence_frames"])
    with run.spans.span("write_sequence"):
        s.dir = str(write_sequence(Sequence(run.traffic, run.seed), run.tmp))
        period = int(run.traffic["period"])
        for t in range(s.frames, period):
            os.remove(os.path.join(s.dir, f"{t:05d}.jpg"))
        shutil.rmtree(s.dir + "_mask")
    with run.spans.span("weights"):
        s.model, s.sd = weights(run)
    s.check_frames, s.check_batches = _drawn(run, s.frames)
    for _ in range(int(run.traffic.get("warm_sequences", 1))):
        mask_sequence(s, run)
    if run.device == "cuda":
        torch.cuda.synchronize()
    return s


def window(s, run, seconds: float, tracer) -> dict:
    import torch

    run.spans.reset()
    captures = count_captures()
    s.tap = Tap(s.check_frames)
    n, last = 0, 0.0
    with s.tap.installed():
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 + last <= seconds:
            t = time.perf_counter()
            s.tap.clear()
            s.started_ns = time.time_ns()
            with (tracer.window() if n == 0 else contextlib.nullcontext()), \
                    run.spans.span("sequence"):
                mask_sequence(s, run)
                if run.device == "cuda":
                    torch.cuda.synchronize()
            last = time.perf_counter() - t
            n += 1
        wall = time.perf_counter() - t0
    run.info["graph_captures_in_window"] = captures()
    run.info["sequences"] = n
    from gflow_tpu_torch.utils.profiling import current

    run.info["counters"] = dict(current().counters)
    layer = {"sequences": n, "frames": n * s.frames, "frame_seconds": wall}
    if tracer.enabled:
        from work import sam_work

        layer["traced"] = {"sequences": 1, "frames": s.frames}
        layer["sam_work"] = sam_work.frame_work(run.config, run.traffic)
    return {"e2e": {"prep_s_per_frame": wall / (n * s.frames)}, "attempted": n,
            "failed": 0, "window_s": wall, "layer": layer}


def release(s) -> dict:
    material = {"dir": s.dir, "frames": s.frames, "sd": s.sd, "tap": s.tap.kept,
                "started_ns": s.started_ns,
                "check_frames": s.check_frames, "check_batches": s.check_batches}
    s.model = None
    return material


def _frame(d: str, t: int):
    import torch

    from PIL import Image

    return torch.from_numpy(np.array(Image.open(os.path.join(d, f"{t:05d}.jpg")))[..., :3])


def _generator(run) -> dict:
    """The configuration's generator settings, which the program and the
    reference generator are both given."""
    return dict(run.config["generator"], union_share=run.config["union_share"])


def reference(material: dict, run, mode: str = "fp32", whole: bool = False) -> dict:
    """The reference's embeddings of the checked frames and, from them, the
    logits and IoUs of the checked batches (with `whole`, of every batch),
    in `mode`."""
    import torch

    from reference.sam import generator as gen, model as ref

    cfg, g = run.config["sam"], run.config["generator"]
    B, dev = g["points_per_batch"], run.device
    sd, out = material["sd"], {}
    prev = ref.MODE
    ref.MODE = mode
    try:
        with torch.inference_mode():
            for f in material["check_frames"]:
                frame = _frame(material["dir"], f).to(dev)
                pts = torch.from_numpy(gen.grid_points(g["points_per_side"], frame.shape[:2],
                                                       cfg["image_size"])).to(dev)
                emb = ref.embed(cfg, sd, frame)
                nb = -(-len(pts) // B)
                low, iou = {}, {}
                for b in (range(nb) if whole else material["check_batches"]):
                    low[b], iou[b] = ref.decode(cfg, sd, emb, pts[B * b:B * (b + 1), None])
                out[f] = {"embed": emb, "low": low, "iou": iou, "points": pts,
                          "hw": tuple(frame.shape[:2])}
    finally:
        ref.MODE = prev
    return out


def _inside(material, f):
    from PIL import Image

    return np.asarray(Image.open(os.path.join(material["dir"] + "_epipolar",
                                              f"{f:05d}_open.png"))) > 127


def _union(material, run, f, low, iou, hw):
    import torch

    from reference.sam import generator as gen

    with torch.inference_mode():
        return gen.select(low, iou, hw, _inside(material, f),
                          dict(_generator(run), image_size=run.config["sam"]["image_size"]))


def _flips(got: np.ndarray, union: np.ndarray, logit: np.ndarray, rel: float):
    finite = np.isfinite(logit)
    band = rel * (np.abs(logit[finite]).max() if finite.any() else 0.0)
    counted = ~(np.abs(logit) < band)
    return int(((got != union) & counted).sum()), got.size


def _gaps(got: dict, want: dict, batches) -> dict:
    """embed_rel_gap, logit_rel_gap and iou_gap over the checked frames,
    and the checked batches of each (missing ones read as infinite)."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    e = l = i = 0.0
    for f, w in want.items():
        k = got.get(f)
        if k is None:
            return {"embed_rel_gap": np.inf, "logit_rel_gap": np.inf, "iou_gap": np.inf}
        e = max(e, rel(k["embed"], w["embed"]))
        for b in batches:
            if b >= len(k["low"]):
                return {"embed_rel_gap": e, "logit_rel_gap": np.inf, "iou_gap": np.inf}
            l = max(l, rel(k["low"][b], w["low"][b]))
            i = max(i, float((k["iou"][b] - w["iou"][b]).abs().max()))
    return {"embed_rel_gap": e, "logit_rel_gap": l, "iou_gap": i}


def numbers(material: dict, run, control: str | None = None) -> dict:
    """The program's answers (or the reference's in the control's
    precision) against the reference's."""
    import torch

    from PIL import Image

    if "reference" not in material:
        material["reference"] = reference(material, run)
    want = material["reference"]
    rel = run.check["limits"]["logit_rel_gap"]
    flips = pixels = mismatch = 0
    if control:
        ctrl = reference(material, run, control, whole=True)
        if "whole" not in material:
            material["whole"] = reference(material, run, whole=True)
        got = {f: {"embed": c["embed"], "low": [c["low"][b] for b in sorted(c["low"])],
                   "iou": [c["iou"][b] for b in sorted(c["iou"])]} for f, c in ctrl.items()}
        for f, c in ctrl.items():
            w = material["whole"][f]
            mine, _, c_counts = _union(material, run, f, torch.cat(got[f]["low"]),
                                       torch.cat(got[f]["iou"]), c["hw"])
            union, logit, counts = _union(material, run, f, torch.cat(list(w["low"].values())),
                                          torch.cat(list(w["iou"].values())), c["hw"])
            a, b = _flips(mine, union, logit, rel)
            flips, pixels = flips + a, pixels + b
            mismatch += len(set(c_counts["nms_kept"]) ^ set(counts["nms_kept"]))
        return dict(_gaps(got, want, material["check_batches"]),
                    mask_flip_share=flips / max(pixels, 1), nms_kept_mismatch=mismatch,
                    prompts_missing=0, mask_files_missing=0)
    tap = material["tap"]
    missing_prompts = 0
    for f, w in want.items():
        k = tap.get(f)
        n = len(w["points"])
        if k is None or not k["points"]:
            missing_prompts += n
            continue
        decoded = torch.cat(k["points"]).to(w["points"])
        near = torch.cdist(w["points"], decoded).amin(1) <= 1e-3
        missing_prompts += int((~near).sum())
        path = os.path.join(material["dir"] + "_mask", f"{f:05d}.png")
        if not os.path.exists(path):
            continue  # counted by mask_files_missing
        written = np.asarray(Image.open(path)) > 127
        union, logit, counts = _union(material, run, f, torch.cat(k["low"])[:n],
                                      torch.cat(k["iou"])[:n], w["hw"])
        kept = counts.pop("nms_kept")
        run.info.setdefault("check_counts", {})[f] = dict(counts, union_px=int(union.sum()))
        a, b = _flips(written, union, logit, rel)
        flips, pixels = flips + a, pixels + b
        mine = k["nms"].tolist() if "nms" in k else []
        mismatch += len(set(mine) ^ set(kept))
    files = 0
    for t in range(material["frames"]):
        p = os.path.join(material["dir"] + "_mask", f"{t:05d}.png")
        frame_hw = Image.open(os.path.join(material["dir"], f"{t:05d}.jpg")).size
        files += int(not os.path.exists(p) or os.stat(p).st_mtime_ns < material["started_ns"]
                     or Image.open(p).size != frame_hw)
    return dict(_gaps(tap, want, material["check_batches"]),
                mask_flip_share=flips / max(pixels, 1), nms_kept_mismatch=mismatch,
                prompts_missing=missing_prompts, mask_files_missing=files)


def check(material: dict, run) -> list[dict]:
    limits = run.check["limits"]
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in numbers(material, run).items()]
