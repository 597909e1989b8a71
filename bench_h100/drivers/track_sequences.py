"""Driver of the video mask prior: the port's ``prep_track.main`` (SAM 2
propagating the first frame's objects through the sequence, the union of
their masks to ``<seq>_mask/<name>.png``) run on whole sequences, one after
another, as a user propagates a first-frame annotation before fitting a
video, with SAM 2 injected at the configuration's widths, its weights made
on the card from the seed, the reference given its own copy.

Set-up: one period of the benchmark's synthetic video with its priors
(``scene/sequence.py`` ``write_sequence``), cut to the configuration's
``sequence_frames`` and without its ``_mask`` folder; the first frame's
annotation, a DAVIS 2017-style palette PNG: index 1 the moving object
(frame 0's ``_open.png``), indices 2 .. ``objects`` static rectangles of
the background drawn from the seed, each ``region_share`` of the frame,
apart from the object and from each other; the weights made; one warm
sequence, so that every graph the window replays is recorded. The window
propagates whole sequences while the last one's duration says the next
ends inside it; at least one runs.

The check, on the window's last sequence. A tap on ``prep_track``'s parts
keeps every frame's memory and object pointer and the bank's choice, and,
for frame 0 and two frames drawn from the seed (one while the bank fills,
frames 1-6, one at or after frame 16), the features, the
memory-conditioned features and the decoder's outputs. The plain
reference (``reference/sam2``) gets the program's own inputs to each step:

- ``feat_rel_gap``: its three FPN levels (the finer two through conv_s0 /
  conv_s1) of the drawn frames against the program's;
- ``memattn_rel_gap``: its memory attention on the program's features over
  the bank built by upstream's rule and order from the program's recorded
  memories and pointers (one object at a time);
- ``logit_rel_gap``, ``iou_gap``, ``obj_score_gap``: its decoder on the
  program's memory-conditioned features and skips (all four masks; the
  IoUs absolute; the object scores relative), and frame 0's logits of the
  mask taken as the output;
- ``memory_rel_gap``: its memory encoder on the program's features and
  chosen mask, and its object pointer (from its own mask token, at the
  program's choice of mask and presence, so that a tie within rounding
  cannot flip them), at frame 0 and the drawn frames;
- ``bank_mismatch``: the frames, temporal indices and pointer offsets the
  program attended at every frame, against upstream's rule (exact);
- ``mask_flip_share``: pixels of the written masks of those frames that
  differ from upstream's choice applied to the program's logits (the best
  of three by predicted IoU, -1024 where the object score is not > 0, to
  the frame's size, > 0, the union), over their pixels; pixels whose
  deciding logit lies within ``logit_rel_gap``'s limit of 0 (relative to
  the largest) do not count;
- ``mask_files_missing``: frames of the last sequence without a mask file
  of the frame's size written by that sequence.

Relative gaps are the largest absolute gap over the reference's largest
absolute value.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np

from gflow_tpu_torch.models import sam2 as _sam2  # noqa: F401 (fails fast without SAM 2)
from harness.counters import count_captures


class Prepared:
    pass


def weights(run):
    """The program's SAM 2 and a copy of its state dict for the reference:
    seeded uniform weights in the released layout (``scene/weights.py``);
    the Fourier features' Gaussian matrix
    standard normal as the released model draws it; the ConvNeXt layer
    scales (``gamma``, which the seeded spread leaves 0) uniform in [0, 1);
    then the values of ``weight_set``."""
    import torch

    from gflow_tpu_torch.models.sam2 import Sam2Config, Sam2Model
    from scene.weights import seeded_state_dict, shapes_of

    with torch.device("meta"):
        model = Sam2Model(Sam2Config(**config_of(run)))
    seed = run.seed * 5 + 7
    sd = seeded_state_dict(shapes_of(model), seed, 1.0, run.device)
    gen = torch.Generator(device=run.device).manual_seed((seed + 1) % 2 ** 63)
    key = "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    sd[key] = torch.randn(sd[key].shape, generator=gen, device=run.device)
    for k in sorted(sd):
        if k.endswith(".gamma"):
            sd[k] = torch.rand(sd[k].shape, generator=gen, device=run.device)
    for k, v in run.config.get("weight_set", {}).items():
        sd[k] = torch.full(sd[k].shape, float(v), device=run.device)
    # each tensor its own allocation: the draw's views into one buffer are
    # not all 16-byte aligned, which the decoder's kernels need
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    return model.to(run.device).eval(), {k: v.clone() for k, v in sd.items()}


def config_of(run) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in run.config["sam2"].items()}


def _regions(inside: np.ndarray, n: int, share, rng) -> np.ndarray:
    """A palette annotation (H, W) uint8: 1 where `inside`, then n static
    rectangles of the background, each a share drawn in `share` of the
    frame, apart from everything drawn before (by a margin of 4 px)."""
    H, W = inside.shape
    ann = inside.astype(np.uint8)
    taken = inside.copy()
    for i in range(n):
        for _ in range(1000):
            area = rng.uniform(*share) * H * W
            aspect = rng.uniform(0.5, 2.0)
            h = int(min(H - 8, max(8, round(np.sqrt(area / aspect)))))
            w = int(min(W - 8, max(8, round(area / h))))
            y, x = int(rng.integers(0, H - h + 1)), int(rng.integers(0, W - w + 1))
            if not taken[max(0, y - 4):y + h + 4, max(0, x - 4):x + w + 4].any():
                break
        else:
            raise RuntimeError(f"no room for region {i + 2} apart from the others")
        ann[y:y + h, x:x + w] = i + 2
        taken[y:y + h, x:x + w] = True
    return ann


def write_annotation(run, seq_dir: str) -> str:
    from PIL import Image

    inside = np.asarray(Image.open(os.path.join(seq_dir + "_epipolar", "00000_open.png"))) > 127
    rng = np.random.default_rng((run.seed * 3 + 1) % 2 ** 63)
    ann = _regions(inside, int(run.traffic["objects"]) - 1, run.traffic["region_share"], rng)
    img = Image.fromarray(ann, mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128] + [0] * 753)
    path = os.path.join(run.tmp, "annotation_00000.png")
    img.save(path)
    return path


def track_sequence(s, run) -> None:
    from gflow_tpu_torch.pipeline import prep_track

    with run.spans.span("prep_track"):
        prep_track.main(s.dir, annotation=s.annotation, device=run.device, model=s.model)


class Tap:
    """While installed, keeps (cloned on the card) what ``prep_track``'s
    parts returned: every frame's memory, object pointer and the bank's
    choice; for the frames in `frames` (and frame 0) the features, the
    memory-conditioned features and the decoder's outputs. ``clear``
    starts a sequence."""

    def __init__(self, frames):
        self.frames = set(frames) | {0}
        self.clear()

    def clear(self) -> None:
        self.frame = -1
        self.memory, self.ptr, self.choice, self.kept = {}, {}, {}, {}

    @contextlib.contextmanager
    def installed(self):
        from gflow_tpu_torch.models.sam2 import MemoryBank, attended
        from gflow_tpu_torch.pipeline import prep_track as pt

        orig = {n: getattr(pt, n) for n in ("encode", "prompt", "memattn", "decode", "memenc")}
        select = MemoryBank.select

        def encode(model, frame, dev):
            out = orig["encode"](model, frame, dev)
            self.frame += 1
            if self.frame in self.frames:
                self.kept[self.frame] = {"feats": tuple(x.clone() for x in out)}
            return out

        def prompt(*a):
            out = orig["prompt"](*a)
            self.ptr[self.frame] = out[1].clone()
            self.kept[0].update(low=out[0].clone(), score=out[2].clone())
            return out

        def memattn(*a):
            out = orig["memattn"](*a)
            if self.frame in self.kept:
                self.kept[self.frame]["cond"] = out.clone()
            return out

        def decode(*a):
            out = orig["decode"](*a)
            self.ptr[self.frame] = out[4].clone()
            if self.frame in self.kept:
                self.kept[self.frame].update(masks=out[0].clone(), iou=out[1].clone(),
                                             score=out[2].clone(), low=out[3].clone(),
                                             ptr=out[4].clone())
            return out

        def memenc(*a):
            out = orig["memenc"](*a)
            self.memory[self.frame] = out.clone()
            return out

        def chosen(bank, f):
            sel = select(bank, f)
            self.choice[f] = attended(sel)
            return sel

        for n, fn in (("encode", encode), ("prompt", prompt), ("memattn", memattn),
                      ("decode", decode), ("memenc", memenc)):
            setattr(pt, n, fn)
        MemoryBank.select = chosen
        try:
            yield self
        finally:
            for n, fn in orig.items():
                setattr(pt, n, fn)
            MemoryBank.select = select


def _drawn(run, frames: int) -> list:
    """The checked frames, drawn from the seed: one while the bank fills
    (1 .. num_maskmem - 1), one with every pointer held (from
    max_obj_ptrs_in_encoder on)."""
    c = run.config["sam2"]
    rng = np.random.default_rng((run.seed + 17) % 2 ** 63)
    filling = int(rng.integers(1, min(c["num_maskmem"], frames)))
    start = min(c["max_obj_ptrs_in_encoder"], frames - 1)
    steady = int(rng.integers(start, frames))
    return sorted({filling, steady})


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
        s.annotation = write_annotation(run, s.dir)
    with run.spans.span("weights"):
        s.model, s.sd = weights(run)
    s.check_frames = _drawn(run, s.frames)
    for _ in range(int(run.traffic.get("warm_sequences", 1))):
        track_sequence(s, run)
    if run.device == "cuda":
        torch.cuda.synchronize()
    return s


def window(s, run, seconds: float, tracer) -> dict:
    import torch

    from gflow_tpu_torch.utils.profiling import current

    run.spans.reset()
    captures = count_captures()
    before = dict(current().counters)  # the warm sequence's, left out
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
                track_sequence(s, run)
                if run.device == "cuda":
                    torch.cuda.synchronize()
            last = time.perf_counter() - t
            n += 1
        wall = time.perf_counter() - t0
    run.info["graph_captures_in_window"] = captures()
    run.info["sequences"] = n
    run.info["counters"] = {k: v - before.get(k, 0) for k, v in current().counters.items()
                            if k.startswith("track/")}
    layer = {"sequences": n, "frames": n * s.frames, "frame_seconds": wall}
    if tracer.enabled:
        from work import sam2_work

        layer["traced"] = {"sequences": 1, "frames": s.frames}
        layer["sam2_work"] = sam2_work.sequence_work(run.config, run.traffic)
    return {"e2e": {"prep_s_per_frame": wall / (n * s.frames)}, "attempted": n,
            "failed": 0, "window_s": wall, "layer": layer}


def release(s) -> dict:
    t = s.tap
    material = {"dir": s.dir, "frames": s.frames, "sd": s.sd, "annotation": s.annotation,
                "started_ns": s.started_ns, "check_frames": s.check_frames,
                "memory": t.memory, "ptr": t.ptr, "choice": t.choice, "kept": t.kept}
    s.model = None
    return material


def _frame(d: str, t: int):
    import torch

    from PIL import Image

    return torch.from_numpy(np.array(Image.open(os.path.join(d, f"{t:05d}.jpg")))[..., :3])


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _first_masks(material, cfg, dev):
    """The annotation's objects at image size, as the program and upstream
    resize them (bilinear with antialias, >= 0.5)."""
    import torch
    import torch.nn.functional as F

    from PIL import Image

    a = np.asarray(Image.open(material["annotation"]))
    ids = [i for i in np.unique(a) if i != 0]
    m = torch.from_numpy(np.stack([a == i for i in ids])).to(dev).float()[:, None]
    S = cfg["image_size"]
    return (F.interpolate(m, (S, S), mode="bilinear", align_corners=False,
                          antialias=True) >= 0.5).float()


def _outputs(material, cfg, before: int) -> dict:
    """The program's recorded memories and pointers of frames < `before`,
    in the reference's layout."""
    from reference.sam2 import model as ref

    out = {}
    for t, mem in material["memory"].items():
        if t >= before or t not in material["ptr"]:
            continue
        B, N, M = mem.shape
        g = int(round(N ** 0.5))
        pos = ref.sine_pe(M, g, g, mem.device).repeat(B, 1, 1, 1)
        out[t] = {"mem": mem.transpose(1, 2).reshape(B, M, g, g), "mem_pos": pos,
                  "ptr": material["ptr"][t]}
    return out


def reference(material: dict, run, mode: str = "fp32") -> dict:
    """The reference's answers, in `mode`, to the program's inputs of each
    checked step: {frame: {"feats", "cond", "masks", "iou", "score", "ptr",
    "memory", "low"}}, frame 0's {"low", "ptr", "score", "memory"}."""
    import torch
    import torch.nn.functional as F

    from reference.sam2 import model as ref

    cfg = dict(run.config["sam2"])
    S, dev, n = cfg["image_size"], run.device, material["frames"]
    sd, kept, out = material["sd"], material["kept"], {}
    prev = ref.MODE
    ref.MODE = mode
    try:
        with torch.inference_mode():
            for f in sorted(kept):
                k = kept[f]
                s0, s1, feat = k["feats"]
                e = ref.encode(cfg, sd, _frame(material["dir"], f).to(dev))
                r = {"feats": (e["s0"], e["s1"], e["feat"])}
                mem = material["memory"].get(f)
                B = mem.shape[0] if mem is not None else 1
                pix = feat.expand(B, -1, -1, -1)
                if f == 0:
                    o = ref.use_mask_as_output(cfg, sd, feat, s0, s1,
                                               _first_masks(material, cfg, dev))
                    r.update(low=o["low"], ptr=o["ptr"], score=o["score"])
                    high = F.interpolate(k["low"], (S, S), mode="bilinear", align_corners=False)
                    r["memory"] = ref.encode_memory(cfg, sd, pix, high, k["score"], True)[0]
                else:
                    memory, pos, nptr, _ = ref.prepare_memory(
                        cfg, sd, f, n, _outputs(material, cfg, f), [0])
                    r["cond"] = torch.cat([ref.condition(cfg, sd, feat, e["pos"],
                                                         memory[:, b:b + 1], pos[:, b:b + 1],
                                                         nptr) for b in range(B)])
                    best = torch.argmax(k["iou"][:, 1:], dim=-1)
                    h = ref.sam_heads(cfg, sd, k["cond"], s0.expand(B, -1, -1, -1),
                                      s1.expand(B, -1, -1, -1), choose=(best, k["score"] > 0))
                    r.update(masks=h["masks"], iou=h["iou"], score=h["score"], ptr=h["ptr"])
                    high = F.interpolate(k["low"], (S, S), mode="bilinear", align_corners=False)
                    r["memory"] = ref.encode_memory(cfg, sd, pix, high, k["score"], False)[0]
                out[f] = r
    finally:
        ref.MODE = prev
    return out


def _chosen_low(masks, iou, score):
    """Upstream's choice on a tracked frame's decoder outputs: the best of
    masks 1-3 by IoU, -1024 where the object score is not > 0."""
    import torch

    best = torch.argmax(iou[:, 1:], dim=-1) + 1
    low = masks[torch.arange(masks.shape[0], device=masks.device), best][:, None]
    return torch.where((score > 0)[:, :, None, None], low, -1024.0)


def _union_logit(low, hw):
    """The deciding logit of the union at the frame's size: the largest of
    the objects' (B, 1, h, w) logits resized to hw."""
    import torch.nn.functional as F

    return F.interpolate(low, hw, mode="bilinear", align_corners=False)[:, 0].amax(0)


def _flips(got: np.ndarray, logit: np.ndarray, rel: float):
    want = logit > 0
    band = rel * np.abs(logit).max()
    counted = ~(np.abs(logit) < band)
    return int(((got != want) & counted).sum()), got.size


def _gaps(got: dict, want: dict) -> dict:
    """The relative and absolute gaps between two sets of answers to the
    checked steps (a missing frame or part reads as infinite)."""
    inf = float("inf")
    g = dict(feat_rel_gap=0.0, memattn_rel_gap=0.0, logit_rel_gap=0.0, iou_gap=0.0,
             obj_score_gap=0.0, memory_rel_gap=0.0)
    for f, w in want.items():
        k = got.get(f)
        if k is None:
            return {n: inf for n in g}
        parts = [("feat_rel_gap", a, b, _rel) for a, b in zip(k.get("feats", ()), w["feats"])]
        if len(k.get("feats", ())) != len(w["feats"]):
            g["feat_rel_gap"] = inf
        names = (("memattn_rel_gap", "cond", _rel), ("logit_rel_gap", "masks", _rel),
                 ("iou_gap", "iou", lambda a, b: float((a - b).abs().max())),
                 ("obj_score_gap", "score", _rel), ("memory_rel_gap", "memory", _rel),
                 ("memory_rel_gap", "ptr", _rel))
        if f == 0:
            names = (("logit_rel_gap", "low", _rel), ("obj_score_gap", "score", _rel),
                     ("memory_rel_gap", "memory", _rel), ("memory_rel_gap", "ptr", _rel))
        for name, key, fn in names:
            if key not in k or key not in w:
                g[name] = inf
            else:
                parts.append((name, k[key], w[key], fn))
        for name, a, b, fn in parts:
            g[name] = max(g[name], fn(a, b) if a.shape == b.shape else inf)
    return g


def _program(material) -> dict:
    """The program's answers to the checked steps, in the reference's
    names."""
    out = {}
    for f, k in material["kept"].items():
        r = {key: k[key] for key in ("feats", "cond", "masks", "iou", "score", "ptr", "low")
             if key in k}
        if f == 0 and 0 in material["ptr"]:
            r["ptr"] = material["ptr"][0]
        if f in material["memory"]:
            B, N, M = material["memory"][f].shape
            g = int(round(N ** 0.5))
            r["memory"] = material["memory"][f].transpose(1, 2).reshape(B, M, g, g)
        out[f] = r
    return out


def _bank_mismatch(material, run) -> int:
    """Memories and pointers the program attended and upstream's rule did
    not choose, or the other way round, summed over the frames."""
    from reference.sam2 import model as ref

    cfg, n = run.config["sam2"], material["frames"]
    miss = 0
    for f in range(1, n):
        mems, ptrs, _ = ref.select_memories(cfg, f, n, [0], set(range(1, f)))
        want_m = {(t, cfg["num_maskmem"] - t_pos - 1) for t_pos, t in mems}
        want_p = {(t, d) for d, t in ptrs}
        got = material["choice"].get(f)
        if got is None:
            miss += len(want_m) + len(want_p)
            continue
        miss += len(set(got["memory"]) ^ want_m) + len(set(got["pointers"]) ^ want_p)
    return miss


def numbers(material: dict, run, control: str | None = None) -> dict:
    """The program's answers (or the reference's in the control's
    precision) against the reference's."""
    import torch

    from PIL import Image

    if "reference" not in material:
        material["reference"] = reference(material, run)
    want = material["reference"]
    rel = run.check["limits"]["logit_rel_gap"]
    got = reference(material, run, control) if control else _program(material)
    flips = pixels = 0
    with torch.inference_mode():
        for f, w in want.items():
            k = got.get(f, {})
            hw = tuple(_frame(material["dir"], f).shape[:2])
            if f == 0:
                logit = _union_logit(w["low"], hw)
                mine = _union_logit(k["low"], hw) if "low" in k else None
            else:
                logit = _union_logit(_chosen_low(w["masks"], w["iou"], w["score"]), hw)
                mine = (_union_logit(_chosen_low(k["masks"], k["iou"], k["score"]), hw)
                        if "masks" in k else None)
            if control:  # the control's union against the reference's logits
                written = mine.cpu().numpy() > 0 if mine is not None else np.zeros(hw, bool)
                logit = logit.cpu().numpy()
            else:  # the written union against upstream's choice on the program's logits
                path = os.path.join(material["dir"] + "_mask", f"{f:05d}.png")
                if not os.path.exists(path):
                    continue  # counted by mask_files_missing
                written = np.asarray(Image.open(path)) > 127
                logit = (logit if mine is None else mine).cpu().numpy()
            a, b = _flips(written, logit, rel)
            flips, pixels = flips + a, pixels + b
    files = 0
    if not control:
        for t in range(material["frames"]):
            p = os.path.join(material["dir"] + "_mask", f"{t:05d}.png")
            frame_hw = Image.open(os.path.join(material["dir"], f"{t:05d}.jpg")).size
            files += int(not os.path.exists(p) or os.stat(p).st_mtime_ns < material["started_ns"]
                         or Image.open(p).size != frame_hw)
    return dict(_gaps(got, want), bank_mismatch=0 if control else _bank_mismatch(material, run),
                mask_flip_share=flips / max(pixels, 1), mask_files_missing=files)


def check(material: dict, run) -> list[dict]:
    limits = run.check["limits"]
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in numbers(material, run).items()]
