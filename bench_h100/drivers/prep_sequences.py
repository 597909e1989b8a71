"""Driver of the prior preparation: the port's ``prep_flow.main``,
``prep_moveseg.main`` and ``prep_depth.main`` run one after another on
whole sequences, as a user prepares a video before fitting it, with the
models injected (GMFlow and MASt3R at the configuration's widths, their
weights made on the card from the seed, shared by the program and the
reference).

Set-up: the frames written (the benchmark's synthetic video), the weights
made, and one warm sequence of the same shape prepared, so that every
graph the window replays is recorded (a user's second video of a batch).
The window prepares whole sequences while the last one's duration says
the next ends inside it; at least one runs.

The check: on the window's last sequence, the plain reference
(``reference/prep``) computes the flows and occlusions of pairs drawn from
the seed, and the depth maps and cameras of the whole sequence, from the
same frames and weights; the files the program wrote are compared with
them. The motion masks of those pairs: a tap on ``prep_moveseg``'s call of
the LMedS keeps the fundamental matrix and inliers it returned; the
reference checks the written error map against that matrix's own map on
its flows, and the written masks against the written map (threshold and
morphology), and reports how far the matrix lies from its float64 refit
and LMedS on the same draws (``reference/prep/epipolar.py``).
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import numpy as np

from harness.counters import count_captures


class Prepared:
    pass


def _models(run):
    """The program's GMFlow and MASt3R and the shared weights."""
    import torch

    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
    from scene.weights import seeded_state_dict, shapes_of

    c = run.config
    out = {}
    for name, cls, cfg_cls, seed_off in (("gmflow", GMFlow, GMFlowConfig, 1),
                                          ("mast3r", Mast3rModel, Mast3rConfig, 2)):
        cfg = cfg_cls(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c[name].items()})
        with torch.device("meta"):
            model = cls(cfg)
        sd = seeded_state_dict(shapes_of(model), run.seed * 3 + seed_off,
                               c["weight_scale"][name], run.device)
        model.load_state_dict(sd, strict=True, assign=True)
        out[name] = (model.to(run.device).eval(), sd)
    return out


def prepare(s, run) -> None:
    """One sequence's priors, as the three CLIs run them."""
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow, prep_moveseg

    c = run.config
    with run.spans.span("prep_flow"):
        prep_flow.main(s.dir, padding_factor=c["padding_factor"],
                       mesh_devices=c["mesh_devices"], device=run.device, model=s.flow)
    with run.spans.span("prep_moveseg"):
        prep_moveseg.main(s.dir, threshold=c["moveseg_threshold"], device=run.device)
    with run.spans.span("prep_depth"):
        prep_depth.main(s.dir, inference_size=c["inference_size"], seg_size=c["seg_size"],
                        winsize=c["winsize"], mesh_devices=c["mesh_devices"],
                        device=run.device, model=s.mast3r)


class LmedsTap:
    """While installed, keeps what each of ``prep_moveseg``'s calls of
    ``find_fundamental_lmeds`` returned (F and the inlier mask, cloned on
    the device), in the order of the pairs; ``clear`` starts a sequence."""

    def __init__(self):
        self.calls = []

    def clear(self) -> None:
        self.calls = []

    @contextlib.contextmanager
    def installed(self):
        from gflow_tpu_torch.pipeline import prep_moveseg

        orig = prep_moveseg.find_fundamental_lmeds

        def kept(*args, **kw):
            F, inliers = orig(*args, **kw)
            self.calls.append((F.clone(), inliers.clone()))
            return F, inliers

        prep_moveseg.find_fundamental_lmeds = kept
        try:
            yield self
        finally:
            prep_moveseg.find_fundamental_lmeds = orig


def setup(run):
    import torch

    from scene.sequence import Sequence, write_frames

    s = Prepared()
    s.frames = int(run.config["sequence_frames"])
    with run.spans.span("write_frames"):
        s.dir = str(write_frames(Sequence(run.traffic, run.seed), run.tmp, s.frames))
    with run.spans.span("weights"):
        m = _models(run)
    s.flow, s.flow_sd = m["gmflow"]
    s.mast3r, s.mast3r_sd = m["mast3r"]
    for _ in range(int(run.traffic.get("warm_sequences", 1))):
        prepare(s, run)
    if run.device == "cuda":
        torch.cuda.synchronize()
    return s


def window(s, run, seconds: float, tracer) -> dict:
    import torch

    run.spans.reset()
    captures = count_captures()
    s.tap = LmedsTap()
    n, last = 0, 0.0
    with s.tap.installed():
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 + last <= seconds:
            t = time.perf_counter()
            s.tap.clear()
            with (tracer.window() if n == 0 else contextlib.nullcontext()), \
                    run.spans.span("sequence"):
                prepare(s, run)
                if run.device == "cuda":
                    torch.cuda.synchronize()
            last = time.perf_counter() - t
            n += 1
        wall = time.perf_counter() - t0
    run.info["graph_captures_in_window"] = captures()
    run.info["sequences"] = n
    layer = {"sequences": n, "frames": n * s.frames, "frame_seconds": wall}
    if tracer.enabled:
        from work import prep_flops

        layer["traced"] = {"sequences": 1, "frames": s.frames}
        layer["work"] = prep_flops.sequence_flops(run.config, run.traffic, s.frames)
    return {"e2e": {"prep_s_per_frame": wall / (n * s.frames)}, "attempted": n,
            "failed": 0, "window_s": wall, "layer": layer}


def release(s) -> dict:
    material = {"dir": s.dir, "frames": s.frames, "flow_sd": s.flow_sd,
                "mast3r_sd": s.mast3r_sd, "lmeds": s.tap.calls}
    s.flow = s.mast3r = None
    return material


def _read_flo(path):
    with open(path, "rb") as f:
        assert np.fromfile(f, np.float32, count=1)[0] == 202021.25
        w, h = np.fromfile(f, np.int32, count=2)
        return np.fromfile(f, np.float32, count=2 * w * h).reshape(h, w, 2)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def outputs(material: dict, run, mode: str = "fp32") -> dict:
    """The reference's answers on the window's last sequence (or the
    control's, in `mode`)."""
    from reference.prep import epipolar, pipeline as ref

    c, d, dev = run.config, material["dir"], run.device
    paths = sorted(glob.glob(os.path.join(d, "*.jpg")))
    rng = np.random.default_rng(run.seed % 2 ** 63)
    pairs = sorted(rng.choice(len(paths) - 1, size=min(int(c["check_pairs"]), len(paths) - 1),
                              replace=False).tolist())
    with ref.mode(mode):
        flow = ref.flows(ref.gmflow(c["gmflow"], material["flow_sd"], dev), paths, pairs,
                         c["padding_factor"], dev)
        depth = ref.depth_and_cameras(ref.mast3r(c["mast3r"], material["mast3r_sd"], dev),
                                      paths, c["inference_size"], c["winsize"], dev)
        lmeds = {i: epipolar.lmeds(flow[i][0], dev) for i in pairs}
    return {"paths": paths, "pairs": pairs, "flow": flow, "depth": depth, "lmeds": lmeds}


def program_outputs(material: dict, want: dict) -> dict:
    """The program's files of the pairs and frames `want` covers, and what
    the tap kept of their LMedS, in the reference's form."""
    d = material["dir"]
    names = [os.path.splitext(os.path.basename(p))[0] for p in want["paths"]]
    flow, seg, lmeds = {}, {}, {}
    for i in want["pairs"]:
        n = names[i]
        flow[i] = (_read_flo(f"{d}_flow_unimatch/{n}_pred.flo"),
                   _read_flo(f"{d}_flow_unimatch/{n}_pred_bwd.flo"),
                   (_png(f"{d}_flow_unimatch/{n}_occ_bwd.png") > 127).astype(np.float32))
        seg[i] = {t: _png(f"{d}_epipolar/{n}_{t}.png") > 127 for t in ("open", "erode", "dilate")}
        seg[i]["error"] = _png(f"{d}_epipolar/{n}_epipolar_error.png")
        F, inl = material["lmeds"][i] if i < len(material["lmeds"]) else (None, None)
        lmeds[i] = {"F": F, "inliers": inl, "png": seg[i]["error"]}
    depth = {"depth": [np.load(f"{d}_depth_mast3r_s2/{n}.npy") for n in names],
             "pose_w2c": [], "focal": None}
    for n in names:
        with open(f"{d}_camera_mast3r_s2/{n}.json") as fh:
            cam = json.load(fh)
        depth["focal"] = cam["focal"]
        depth["pose_w2c"].append(np.asarray(cam["pose"]))
    return {"pairs": want["pairs"], "flow": flow, "seg": seg, "depth": depth, "lmeds": lmeds}


def mask_violations(seg: dict, threshold: float) -> float:
    """The share of mask pixels outside what the program's own error map
    allows (``reference.prep.pipeline.masks_between``)."""
    from reference.prep import pipeline as ref

    bad = n = 0
    for m in seg.values():
        lo, hi = ref.masks_between(m["error"], threshold)
        for t in ("open", "erode", "dilate"):
            bad += int((m[t] & ~hi[t]).sum() + (~m[t] & lo[t]).sum())
            n += m[t].size
    return bad / max(n, 1)


# the LMedS readings compared; the others go to the run's info
COMPARED_LMEDS = ("map_off",)


def compare(got: dict, want: dict, device, info: dict) -> dict:
    """The compared numbers between two sets of answers; into `info` the
    readings of the LMedS's F, reported but not compared (PERF.md: on
    these flows the TF32 control reads them no further from the reference
    than the program does, so no limit holds)."""
    from reference.prep import epipolar

    flow_gap, occ_flips, occ_n = 0.0, 0, 0
    for i in want["pairs"]:
        for g, w in zip(got["flow"][i][:2], want["flow"][i][:2]):
            flow_gap = max(flow_gap, float(np.abs(g - w).max()))
        occ_flips += int(((got["flow"][i][2] > 0.5) != (want["flow"][i][2] > 0.5)).sum())
        occ_n += want["flow"][i][2].size
    gd, wd = got["depth"], want["depth"]
    depth_gap, pose_gap = 0.0, 0.0
    for f, w in enumerate(wd["depth"]):
        scale = float(np.median(np.abs(w)))
        depth_gap = max(depth_gap, float(np.abs(gd["depth"][f] - w).max()) / scale)
        P, Q = np.asarray(gd["pose_w2c"][f]), np.asarray(wd["pose_w2c"][f])
        pose_gap = max(pose_gap, float(np.abs(P[:3, :3] - Q[:3, :3]).max()),
                       float(np.abs(P[:3, 3] - Q[:3, 3]).max()) / scale)
    focal_gap = abs(gd["focal"] - wd["focal"]) / abs(wd["focal"])
    lm = {}
    for i in want["pairs"]:
        g = got["lmeds"][i]
        j = epipolar.judge(want["flow"][i][0], g["F"], g["inliers"], g["png"],
                           want["lmeds"][i]["median"], device)
        lm = {k: max(lm.get(k, 0.0), v) for k, v in j.items()}
    info.update({"lmeds_" + k: v for k, v in lm.items() if k not in COMPARED_LMEDS})
    return {"flow_gap_px": flow_gap, "occ_flip_share": occ_flips / max(occ_n, 1),
            "depth_rel_gap": depth_gap, "camera_gap": max(pose_gap, focal_gap),
            **{"lmeds_" + k: lm[k] for k in COMPARED_LMEDS}}


def numbers(material: dict, run, control: str | None = None) -> dict:
    """The program's answers (or the reference's in the control's
    precision) against the reference's; the program's masks also against
    its own written error map."""
    if "reference" not in material:
        material["reference"] = outputs(material, run)
    want = material["reference"]
    info = run.info.setdefault(f"check_{control or 'program'}", {})
    if control:
        return compare(outputs(material, run, control), want, run.device, info)
    got = program_outputs(material, want)
    return dict(compare(got, want, run.device, info),
                moveseg_mask_violations=mask_violations(got["seg"],
                                                        run.config["moveseg_threshold"]))


def check(material: dict, run) -> list[dict]:
    limits = run.check["limits"]
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in numbers(material, run).items()]
