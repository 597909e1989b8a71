"""Driver of the per-frame fit: the port's ``GFlowTrainer`` driven frame by
frame exactly as ``gflow_tpu_torch/pipeline/fit_video.py`` drives it
(its set-up, frame 0, the trajectory queries, then per frame the gt IO,
the camera-only stage, the full stage, the attribute check and the
trajectory eval), on the benchmark's periodic synthetic video fed
cyclically, so that any window has frames.

``fit_video.main`` has no per-frame boundary at which a window could stop,
so the driver runs its loop body itself, with the configuration's
arguments and the same helpers (``_collect_stage``,
``_select_traj_queries``, ``_eval_traj``).

Set-up: the video written, the trainer built, frame 0 fitted, the
trajectory queries chosen and warm frames fitted, so that every graph
the window replays is recorded, and the background writes drained. The window then fits whole frames while it
has time left, and drains the background writer.

The check, on the window's first frame: the driver keeps (on the card) the
trainer's state before its camera-only stage and before its full stage;
while each stage runs, a tap on the stage's graph runner reads its
buffers as the first step starts, after it and after the third (Adam's
first moment, so the first gradient as the optimizer got it, and the
parameters); after each stage it keeps the stage's loss trace, its
parameters and n_alive. After the window the plain reference
(``reference/gs/stage.py``) runs each stage from the same kept state to
its end, on the targets it reads itself from the benchmark's files, and
``numbers`` compares the two: the first steps' losses, the first
gradient and the parameters' change after three steps by the worst leaf,
and at the stage's end the last losses, the change by the worst leaf,
the points densify added and whether every iteration left a loss.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from harness.counters import count_captures

STEPS = 3  # the first steps, compared step by step
LAST = 10  # the stage's last losses, compared as a mean


def _telemetry(spans):
    """The program's Telemetry, whose phases also open a profiler range
    while the window is traced."""
    from gflow_tpu_torch.utils.profiling import Telemetry

    class PhaseTelemetry(Telemetry):
        @contextlib.contextmanager
        def phase(self, name):
            rf = contextlib.nullcontext()
            if spans.tracing:
                from torch.profiler import record_function

                rf = record_function("phase:" + name)
            with rf, Telemetry.phase(self, name):
                yield

    return PhaseTelemetry()


class Prepared:
    pass


def setup(run):
    import torch

    from gflow_tpu_torch.core import io as gio
    from gflow_tpu_torch.pipeline import fit_video as fv
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer
    from gflow_tpu_torch.utils.bgwriter import flush_writes
    from scene.sequence import Sequence, write_sequence

    a = run.config["fit_video"]
    s = Prepared()
    s.a, s.run = a, run
    s.seq = Sequence(run.traffic, run.seed)
    s.period = s.seq.period
    with run.spans.span("write_sequence"):
        s.dir = write_sequence(s.seq, run.tmp)
    resize, blur = a["resize"], False
    files = gio.list_sequence_files(s.dir)
    focal, pp, _ = gio.read_camera(files["cameras"])
    s.move_masks = [gio.read_mask(str(s.dir) + f"_epipolar/{t:05d}_open.png", resize=resize)
                    for t in range(s.period)]
    s.collect = {k: [] for k in ("seq", "center_seq", "depth_seq", "opt", "center_opt",
                                 "depth_opt", "still_seq", "still_center_seq", "move_seq",
                                 "move_center_seq", "traj", "traj_upon", "move_seg")}
    s.sequence_traj, s.sequence_traj_occlusion = [], []
    s.telemetry = tel = _telemetry(run.spans)
    img0 = os.path.join(str(s.dir), "00000.jpg")
    with tel.phase("host/init"):
        gt_image0 = gio.load_image(img0, resize=resize, blur=blur)
        gt_depth0 = gio.read_depth(str(s.dir) + "_depth_mast3r_s2/00000.npy", resize=resize,
                                   depth_scale=1.0, depth_offset=a["depth_offset"])
        tr = GFlowTrainer(gt_image=gt_image0, gt_depth=gt_depth0,
                          num_points=a["num_points"], background=a["background"],
                          sequence_path=s.dir, logs_suffix=a["logs_suffix"],
                          common_logs=a["common_logs"], seed=run.seed % 2 ** 63,
                          rebin_every=a["rebin_every"], device=run.device)
        tr.telemetry = tel
        tr.load_camera(focal=focal, pp=pp)
        tr.init_gaussians_from_image(gt_image0, gt_depth0, num_points=a["num_points"])
    s.trainer = tr
    with tel.phase("frame0_fit"):
        out = tr.train(
            iterations=a["iterations_first"], lr=a["lr"], lr_camera=a["lr_camera"],
            save_imgs=True, save_videos=True, save_ckpt=True, ckpt_name="00000",
            lambda_rgb=a["lambda_rgb"], lambda_depth=a["lambda_depth"],
            lambda_var=a["lambda_var"], lambda_scale=a["lambda_scale"],
            densify_times=a["densify_times"], densify_interval=a["densify_interval"],
            move_mask=s.move_masks[0], densify_occ_percent=a["densify_occ_percent"],
            densify_err_thre=a["densify_err_thre"],
            densify_err_percent=a["densify_err_percent"])
    tel.count_frame(a["iterations_first"])
    fv._collect_stage(s.collect, out, first=True)
    mask_dir = str(s.dir) + "_mask/00000.png"
    if os.path.exists(mask_dir):
        tr.init_mask_prompt_pts(gio.read_mask(mask_dir, resize=resize), ckpt_name="00000")
    s.traj = ([], None, 0, None)
    if a["traj_num"]:
        with tel.phase("host/traj_select"):
            s.traj = fv._select_traj_queries(tr)
        with tel.phase("host/traj_eval"):
            fv._eval_traj(tr, s.traj[0], s.traj[1], s.collect, s.sequence_traj,
                          s.sequence_traj_occlusion)
    s.next_frame = 1
    # warm frames until one records no graph: a K escalation at the end of
    # a warm frame makes the next frame's stages record theirs
    for _ in range(int(run.traffic["max_warm_frames"])):
        captures = count_captures()
        fit_frame(s, s.next_frame)
        s.next_frame += 1
        if captures() == 0:
            break
    run.info["warm_frames"] = s.next_frame - 1
    # set-up's queued writes (frame 0's three videos, the warm frames'
    # images) finish here: drained inside the window they slowed its first
    # frames on a shared host
    flush_writes()
    if run.device == "cuda":
        torch.cuda.synchronize()
    s.keep = None
    return s


def fit_frame(s: Prepared, k: int, keep: dict | None = None) -> None:
    """fit_video's per-frame loop body for global frame k of the cyclic
    feed. With `keep`, the state the reference starts each stage from and
    each stage's loss trace go into it."""
    import torch

    from gflow_tpu_torch.core import io as gio
    from gflow_tpu_torch.pipeline import fit_video as fv
    from scene.sequence import frame_files

    a, tr, tel = s.a, s.trainer, s.telemetry
    f = frame_files(s.dir, s.period, k)
    resize, blur = a["resize"], False
    save_name = os.path.basename(f["image"]).split(".")[0]
    with tel.phase("host/gt_io"):
        tr.set_gt_image(gio.load_image(f["image"], resize=resize, blur=blur))
        tr.set_gt_depth(gio.read_depth(f["depth"], resize=resize, depth_scale=1.0,
                                       depth_offset=a["depth_offset"]))
        occ_mask = gio.load_image(f["occ"], resize=resize)[..., 0]
        tr.set_gt_flow(gio.read_flow(f["flow"], resize=resize, blur=blur))
        mm = s.move_masks[k % s.period]
    tap = keep.get("tap") if keep is not None else None
    if keep is not None:
        keep["files"] = f
        keep["camera"] = _state(tr)
    if a["camera_first"]:
        if tap is not None:
            tap.stage(keep["camera"])
        with tel.phase("camera_stage"):
            out = tr.train(
                iterations=a["iterations_camera"], lr_camera=a["lr_camera_after"],
                save_imgs=True, save_ckpt=True, ckpt_name=save_name,
                lambda_rgb=a["lambda_rgb"], lambda_depth=a["lambda_depth"],
                lambda_var=0.0, lambda_still=0.0, lambda_flow=a["lambda_flow"],
                camera_only=True, move_mask=mm,
                densify_occ_percent=a["densify_occ_percent"],
                densify_err_thre=a["densify_err_thre"],
                densify_err_percent=a["densify_err_percent"])
        if keep is not None:
            _ended(keep["camera"], tr)
        for k_src, k_dst in (("frames", "opt"), ("frames_center", "center_opt"),
                             ("frames_depth", "depth_opt")):
            s.collect[k_dst].append(out[k_src])
    if keep is not None:
        keep["full"] = _state(tr)
        if tap is not None:
            tap.stage(keep["full"])
    if a["iterations_after"] > 0:
        with tel.phase("full_stage"):
            out = tr.train(
                iterations=a["iterations_after"], lr=a["lr_after"], lr_camera=0.0,
                save_imgs=True, save_ckpt=True, ckpt_name=save_name,
                lambda_rgb=a["lambda_rgb"], lambda_depth=a["lambda_depth"],
                lambda_var=a["lambda_var"], lambda_still=a["lambda_still"],
                lambda_scale=a["lambda_scale"], lambda_flow=a["lambda_flow"],
                densify_times=a["densify_times_after"],
                densify_interval=a["densify_interval_after"],
                mask=occ_mask, move_mask=mm, densify_occ_percent=a["densify_occ_percent"],
                densify_err_thre=a["densify_err_thre"],
                densify_err_percent=a["densify_err_percent"])
        if keep is not None:
            _ended(keep["full"], tr)
    tel.count_frame(a["iterations_camera"] * int(a["camera_first"]) + a["iterations_after"])
    with tel.phase("host/attr_check"):
        sc = tr.get_attribute("scale")
        torch.stack([sc.max(), sc.min(), tr.state.n_alive.float()]).cpu().tolist()
        fv._collect_stage(s.collect, out, first=False)
    if a["traj_num"]:
        with tel.phase("host/traj_eval"):
            fv._eval_traj(tr, s.traj[0], s.traj[1], s.collect, s.sequence_traj,
                          s.sequence_traj_occlusion)


def _state(tr) -> dict:
    """What a stage starts from, kept on the device (clones: the trainer
    goes on): parameters, frame state, densify generator, intrinsics, the
    render configuration, and whether a previous frame exists."""
    import torch

    return {"params": [t.clone() for t in tr.params],
            "state": [t.clone() for t in tr.state],
            "gen": tr.gen.get_state().clone(),
            "intr": tr.intr.clone(),
            "render": tr.render_config,
            "has_last": tr._last_num_host > 0,
            "capacity": tr.capacity,
            "num_points": tr.num_points,
            "bg": tr.bg}


def _ended(k: dict, tr) -> None:
    """What a stage left, kept on the device: its loss trace, parameters
    and n_alive."""
    info = tr._last_info
    k["losses"] = info["loss_trace"]
    k["end"] = [t.clone() for t in tr.params]
    k["n_alive_end"] = info["n_alive"].clone()


class StepTap:
    """Reads a stage's buffers around its steps while installed: the
    program runs each iteration as ``runner("step", fn)`` on the stage's
    buffers (``opt/graphs.py``: ``StageGraphs`` replays a CUDA graph,
    ``Eager`` calls fn), so a wrapper of that call sees the parameters as
    the first step starts ("start", n_alive with them), Adam's first moment
    after it ("m1") and the parameters after the STEPS-th ("at"). Clones on
    the device, no read back."""

    def __init__(self):
        self.k, self.calls = None, 0

    def stage(self, k: dict) -> None:
        self.k, self.calls = k, 0

    def _seen(self, buf, before: bool) -> None:
        if before:
            if self.calls == 0:
                self.k["start"] = [t.clone() for t in buf.params]
                self.k["n_alive_start"] = buf.n_alive.clone()
            return
        self.calls += 1
        if self.calls == 1:
            self.k["m1"] = [t.clone() for t in buf.opt.m]
        if self.calls == STEPS:
            self.k["at"] = [t.clone() for t in buf.params]

    @contextlib.contextmanager
    def installed(self):
        from gflow_tpu_torch.opt import graphs

        tap = self
        originals = {cls: cls.__call__ for cls in (graphs.StageGraphs, graphs.Eager)}

        def wrapped(orig):
            def call(runner, name, fn):
                live = tap.k is not None and name == "step"
                if live:
                    tap._seen(runner.buffers, True)
                out = orig(runner, name, fn)
                if live:
                    tap._seen(runner.buffers, False)
                return out
            return call

        for cls, orig in originals.items():
            cls.__call__ = wrapped(orig)
        try:
            yield self
        finally:
            for cls, orig in originals.items():
                cls.__call__ = orig


def window(s: Prepared, run, seconds: float, tracer) -> dict:
    import torch

    from gflow_tpu_torch.utils.bgwriter import flush_writes

    tel = s.telemetry = _telemetry(run.spans)
    s.trainer.telemetry = tel
    run.spans.reset()
    captures = count_captures()
    traced_at = 1 if tracer.enabled else -1
    frames, s.keep = 0, {}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    per_frame = {"wall": [], "stage": [], "hull": []}
    while frames == 0 or time.perf_counter() < deadline or frames <= traced_at:
        if frames == 0:
            s.keep["tap"] = StepTap()
            ctx = s.keep["tap"].installed()
        else:
            ctx = tracer.window() if frames == traced_at else contextlib.nullcontext()
        t, ph = time.perf_counter(), dict(tel.phase_seconds)
        with ctx, run.spans.span("frame"):
            fit_frame(s, s.next_frame, keep=s.keep if frames == 0 else None)
        per_frame["wall"].append(time.perf_counter() - t)
        for key, phase in (("stage", "device/stage"), ("hull", "host/hull_seg")):
            per_frame[key].append(tel.phase_seconds[phase] - ph.get(phase, 0.0))
        s.next_frame += 1
        frames += 1
    with run.spans.span("io_flush"):
        flush_writes()
    if run.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run.info["graph_captures_in_window"] = captures()
    run.info["per_frame"] = per_frame
    if run.device == "cuda":
        from harness.device import smi

        run.info["smi_after_window"] = smi()
    its = frames * (s.a["iterations_camera"] * int(s.a["camera_first"])
                    + s.a["iterations_after"])
    phases = dict(tel.phase_seconds)
    layer = {"frames": frames, "iterations": its, "telemetry": phases,
             "frame_seconds": wall}
    if tracer.enabled:
        layer["traced"] = {"frames": 1, "iterations": its // frames}
        layer["work"] = _work(s)
    run.info.update(frames=frames, phases={k: v for k, v in phases.items()},
                    k_escalations=getattr(s.trainer, "k_escalations", []),
                    render_config=str(s.trainer.render_config))
    return {"e2e": {"fit_s_per_frame": wall / frames}, "attempted": frames, "failed": 0,
            "window_s": wall, "layer": layer}


def _work(s: Prepared) -> dict:
    """The step's least time on the published peaks, part by part, from the
    scene at the window's end and the benchmark's frozen plain binning."""
    import torch

    from work import fit_step

    tr = s.trainer
    with torch.no_grad():
        return fit_step.iteration_least_seconds(tr.params, tr.state.n_alive, tr.intr,
                                                tr.render_config, tr.W, tr.H)


def release(s: Prepared) -> dict:
    """Everything the check needs; the trainer and its graphs go."""
    keep, a, seq_dir, period = s.keep, s.a, s.dir, s.period
    s.trainer = None
    s.collect = None
    return {"keep": keep, "a": a, "dir": seq_dir, "period": period}


def _targets(files, occ: bool, device):
    """The stage's targets, read by the reference from the benchmark's files
    (PIL decodes the JPEG, as any reader does)."""
    import torch
    from PIL import Image

    from reference.gs.state import Targets

    img = np.asarray(Image.open(files["image"]), np.float32)[..., :3] / 255.0
    depth = np.load(files["depth"]).astype(np.float32)[..., None]
    with open(files["flow"], "rb") as fh:
        hdr = np.fromfile(fh, np.float32, count=1)
        assert hdr[0] == 202021.25
        w, h = np.fromfile(fh, np.int32, count=2)
        flow = np.fromfile(fh, np.float32, count=2 * w * h).reshape(h, w, 2)
    mm = np.asarray(Image.open(files["move_mask"]), np.float32)
    mm = (mm.sum(-1) if mm.ndim == 3 else mm) > 0
    if occ:
        om = np.asarray(Image.open(files["occ"]), np.float32)
        om = (om[..., 0] if om.ndim == 3 else om) > 0
    else:
        om = np.zeros(mm.shape, bool)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return Targets(image=t(img), depth=t(depth), flow=t(flow), move_mask=t(mm),
                   occ_mask=t(om))


def _reference(material: dict, which: str, mode: str = "fp32") -> dict:
    """The reference's record of the first window frame's stage `which`
    ("camera" or "full"), run to its end in `mode` (``_summary``'s form)."""
    import torch

    from reference.gs import stage as ref
    from reference.gs.losses import LossWeights
    from reference.gs.state import FrameState, Params

    a, k = material["a"], material["keep"][which]
    dev = k["params"][0].device
    targets = _targets(material["keep"]["files"], which == "full", dev)
    H, W = targets.image.shape[:2]
    camera = which == "camera"
    st = ref.Stage(
        W=W, H=H, iterations=a["iterations_camera"] if camera else a["iterations_after"],
        camera_only=camera, propagate=k["has_last"] and not camera,
        densify_occ=k["has_last"] and not camera,
        densify_interval=0 if camera else a["densify_interval_after"],
        densify_times=1 if camera else a["densify_times_after"],
        max_densify=min(k["capacity"], 16384), bg=k["bg"],
        lr=0.01 if camera else a["lr_after"],
        lr_camera=a["lr_camera_after"] if camera else 0.0,
        weights=LossWeights(rgb=a["lambda_rgb"], depth=a["lambda_depth"],
                            var=0.0 if camera else a["lambda_var"],
                            scale=0.0 if camera else a["lambda_scale"],
                            still=0.0 if camera else a["lambda_still"],
                            flow=a["lambda_flow"]),
        num_points=k["num_points"], densify_occ_percent=a["densify_occ_percent"],
        densify_err_thre=a["densify_err_thre"], densify_err_percent=a["densify_err_percent"])
    rc = k["render"]
    binning = ref.Binning(rc.max_per_tile, rc.max_tiles_per_gaussian,
                          rc.small_tiles_per_gaussian, rc.large_frac)
    gen = torch.Generator(device=dev)
    gen.set_state(k["gen"])
    params = Params(*(t.clone() for t in k["params"]))
    state = FrameState(*(t.clone() for t in k["state"]))
    r = ref.run_stage(params, state, targets, k["intr"], st, binning, gen, STEPS, mode)
    return _summary(r["start"], r["n_alive_start"], r["grad0"], r.get("at"), r["end"],
                    r["losses"], r["n_alive_end"], st.iterations)


def _program(material: dict, which: str) -> dict:
    """The program's record of the first window frame's stage `which`, from
    what the tap and the driver kept (``_summary``'s form). The first
    gradient is Adam's first moment after one step over (1 - beta1), the
    moment starting at zero."""
    k, a = material["keep"][which], material["a"]
    iterations = a["iterations_camera"] if which == "camera" else a["iterations_after"]
    tapped = all(key in k for key in ("start", "m1", "at"))
    grad0 = [m / (1.0 - ADAM_B1) for m in k["m1"]] if tapped else None
    return _summary(k.get("start", k["end"]), int(k.get("n_alive_start", 0)), grad0,
                    k.get("at"), k["end"], k["losses"].cpu().tolist(), int(k["n_alive_end"]),
                    iterations)


ADAM_B1 = 0.9  # the port's adam_update's default, which the trainer keeps


def _summary(start, n0: int, grad0, at, end, losses, n_end: int, iterations: int) -> dict:
    """Per-leaf norms over the points alive as the stage's first step
    starts (a whole leaf for pose and depth_ab): the first gradient, the
    change after STEPS steps and at the end (densify's new points are
    counted by n_alive, not here); the losses; n_alive at the end; and the
    iterations that left no finite positive loss (with any shortfall of
    the trace's length)."""
    import torch

    cap = start[0].shape[0]

    def rows(x):
        return x[:n0] if x.dim() and x.shape[0] == cap else x

    def norms(xs, base=None):
        if xs is None:
            return None
        return [float(torch.linalg.vector_norm(rows(x - b if base is not None else x)))
                for x, b in zip(xs, base if base is not None else xs)]

    t = torch.as_tensor(losses, dtype=torch.float64)
    unfilled = int((~(torch.isfinite(t) & (t > 0))).sum()) + abs(iterations - len(losses))
    return {"grad0": norms(grad0), "change_at": norms(at, start),
            "change_end": norms(end, start), "losses": [float(x) for x in losses],
            "n_alive_end": n_end, "unfilled": unfilled}


def _worst_leaf(got, ref, keep) -> float:
    """The largest gap of a leaf's norm to the reference's, over the kept
    leaves, against the larger of the reference's norm of that leaf and of
    the median kept leaf; inf where the program left nothing to read."""
    if got is None:
        return float("inf")
    med = float(np.median([ref[i] for i in keep]))
    return max(abs(got[i] - ref[i]) / max(ref[i], med, 1e-30) for i in keep)


def _kept_leaves(grad0) -> list[int]:
    """The leaves whose reference gradient is not nought: gated leaves
    (exactly 0) go, and so do those under a thousandth of the median
    nonzero leaf's (moved by round-off alone under Adam)."""
    nz = [g for g in grad0 if g > 0]
    med = float(np.median(nz)) if nz else 0.0
    return [i for i, g in enumerate(grad0) if g > 0 and g >= 1e-3 * med]


def _gaps(got: dict, ref: dict) -> dict:
    keep = _kept_leaves(ref["grad0"])
    rel = lambda g, r: abs(g - r) / max(abs(r), 1e-12)
    mean_last = lambda x: float(np.mean(x[-LAST:]))
    return {"step0_gap": rel(got["losses"][0], ref["losses"][0]),
            "loss_gap": max(rel(g, r) for g, r in zip(got["losses"][:STEPS],
                                                      ref["losses"][:STEPS])),
            "grad_gap": _worst_leaf(got["grad0"], ref["grad0"], keep),
            "change_gap": _worst_leaf(got["change_at"], ref["change_at"], keep),
            "end_change_gap": _worst_leaf(got["change_end"], ref["change_end"], keep),
            "end_loss_gap": rel(mean_last(got["losses"]), mean_last(ref["losses"])),
            "alive_gap": rel(got["n_alive_end"], ref["n_alive_end"]),
            "trace_unfilled": float(got["unfilled"])}


def numbers(material: dict, run, control: str | None = None) -> dict:
    """The compared numbers of both stages of the first window frame, each
    the larger of the two: the program's record (control None), or the
    reference's in the control's mode, against the reference's.
    ``step0_gap``: the first step's loss (the forward and the losses,
    before any update). ``loss_gap``: the first STEPS steps' losses (the
    gradient, the gated Adam step, the propagation and the occluded
    densify follow, where Adam's sign-normalised first steps amplify
    rounding). ``grad_gap`` and ``change_gap``: the first gradient and the
    parameters' change after STEPS steps, by the worst leaf.
    ``end_change_gap``, ``end_loss_gap`` (the mean of the LAST losses) and
    ``alive_gap`` (n_alive): at the stage's end, after every iteration and
    the error densify. ``trace_unfilled``: iterations that left no loss."""
    cache = material.setdefault("reference", {})
    out = {}
    for which in ("camera", "full"):
        if which not in cache:
            cache[which] = _reference(material, which, "fp32")
        ref = cache[which]
        got = _reference(material, which, control) if control else _program(material, which)
        gaps = _gaps(got, ref)
        run.info.setdefault(f"check_{control or 'program'}", {})[which] = dict(
            gaps, losses_first=got["losses"][:STEPS], reference_first=ref["losses"][:STEPS],
            grad0=got["grad0"], reference_grad0=ref["grad0"],
            n_alive_end=got["n_alive_end"], reference_n_alive_end=ref["n_alive_end"])
        for key, v in gaps.items():
            out[key] = max(out.get(key, 0.0), v)
    return out


def check(material: dict, run) -> list[dict]:
    limits = run.check["limits"]
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in numbers(material, run).items()]
