"""Where the prior preparation's time goes on the card, at the released widths.

    python3 scripts/torch_profile_prep.py [--only gmflow,mast3r,lmeds,align,step]

Seeded random weights (x0.5 GMFlow, x0.3 MASt3R, as chip_smoke.py). Each
part is timed as CUDA graphs (the default) and eagerly
(``opt.graphs.disable_graphs()``) in turns (graphed, eager, eager,
graphed), after one warm-up call of each (the graphed one records). Per
model: the median seconds of a directed pair, the seconds of its parts
(timed wrappers around the module's functions and forwards, the card
synchronized at each; eager), and torch.profiler's top device kernels and
top aten ops (by the device time of their kernels, with input shapes) of
one eager call, and its device idle share (1 - the device kernels' time
over the eager call's median seconds); the models also with cuDNN off and
with its autotuner on.
GMFlow runs at 864x480, MASt3R catmlp+dpt at 512x288, the LMedS on a
rigid scene's 854x480 flow (its eager split: the draws' copy to the card,
the 512 minimal solutions, the scoring with its sort, the refit; and
small_eig against torch.linalg.eigh on the 512 9x9 matrices),
global_align's Adam steps on a 10-edge graph of seeded pointmaps, and the
B-frame step (``parallel.multichip``) over a (2 data x 2 tile) mesh on
the visible cards, round robin, at dryrun_step's 64x48 and at the fit's
854x480. Prints JSON lines and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def timed_parts(owner, names, seconds):
    """Patch owner.<name> to add its synchronized seconds to
    seconds["<owner>.<name>"]."""
    stack = ExitStack()
    for name in names:
        fn = getattr(owner, name)
        key = f"{getattr(owner, '__name__', owner)}.{name}"

        def run(*a, _fn=fn, _key=key, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            seconds[_key] = seconds.get(_key, 0.0) + time.perf_counter() - t0
            return out

        stack.enter_context(mock.patch.object(owner, name, run))
    return stack


def _device_us(e, self_only):
    for name in (("self_device_time_total", "self_cuda_time_total") if self_only
                 else ("device_time_total", "cuda_time_total")):
        us = getattr(e, name, None)
        if us:
            return us
    return 0


def top_ops(fn, n=15):
    """The top device kernels of one fn() by their own device time, and
    the top aten ops by the device time of the kernels they launch, with
    their input shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, aten = [], []
    busy_us = sum(_device_us(e, True) for e in prof.key_averages()
                  if not e.key.startswith("aten::") and e.device_type == DeviceType.CUDA)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key.startswith("aten::"):
            us = _device_us(e, False)
            if us:
                aten.append((us, e.count, e.key, str(e.input_shapes)[:120]))
        else:
            us = _device_us(e, True)
            if us:
                kernels.append((us, e.count, e.key, ""))
    out = {"device_busy_ms": busy_us / 1e3}
    for name, rows in (("kernels", kernels), ("aten", aten)):
        rows = sorted(set(rows), reverse=True)[:n]
        out[name] = [{"op": k[:60], "ms": us / 1e3, "calls": c, **({"shapes": sh} if sh else {})}
                     for us, c, k, sh in rows]
    return out


def without_cudnn_and_autotuned(call):
    """The median seconds of call() with cuDNN off (ATen's im2col + GEMM
    convolutions) and with cuDNN's autotuner on."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=False, allow_tf32=False):
        off = median_s(call)
    with cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
        tuned = median_s(call)
    return {"s_per_pair_without_cudnn": off, "s_per_pair_cudnn_autotuned": tuned}


def median_s(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


TURNS = ("graphed", "eager", "eager", "graphed")


def in_turns(fn, reps=3):
    """median_s(fn) graphed and eager in TURNS, after one warm-up call of
    each (the graphed one records its graphs): {mode: [s, s]}."""
    from gflow_tpu_torch.opt.graphs import disable_graphs

    out = {"graphed": [], "eager": []}
    for mode in ("graphed", "eager"):
        with disable_graphs() if mode == "eager" else ExitStack():
            fn()
    for mode in TURNS:
        with disable_graphs() if mode == "eager" else ExitStack():
            out[mode].append(median_s(fn, reps))
    return out


def event_ms(fn, reps=20):
    """Median ms of fn() between CUDA events (the host's launch time
    included where the card waits for it)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gmflow():
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert, gmflow as g
    from gflow_tpu_torch.pipeline import prep_flow

    model = GMFlow(GMFlowConfig()).cuda().eval()
    model.load_state_dict(seeded_state_dict(convert.expected_torch_keys(), 0, 0.5))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 480, 864, 3)).astype(np.float32)).cuda()
            for _ in range(2))
    call = lambda: model(a, b)
    run = prep_flow.batch_runner(model, 0, a.device, prep_flow.FLOW_GRAPHS)[0]
    with torch.inference_mode():
        s = in_turns(lambda: run(a, b))
        s_routes = without_cudnn_and_autotuned(call)
        parts = {}
        names = ["local_correlation_with_flow", "local_correlation_softmax",
                 "global_correlation_softmax", "_bilinear_sample", "upsample_flow_with_mask"]
        with timed_parts(g, names, parts), \
                timed_parts(g.FeatureTransformer, ["forward"], parts), \
                timed_parts(g.CNNEncoder, ["forward"], parts), \
                timed_parts(g.SelfAttnPropagation, ["forward"], parts), \
                timed_parts(g.BasicUpdateBlock, ["forward"], parts):
            call()
        ops = top_ops(call)
    return {"model": "gmflow 864x480", "s_per_pair": s, **s_routes, "parts_s": parts,
            "eager_idle_share": 1 - ops["device_busy_ms"] / 1e3 / float(np.median(s["eager"])),
            "top_ops": ops}


def mast3r():
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow

    cfg = Mast3rConfig(head="catmlp+dpt")
    sd = seeded_state_dict(convert.expected_torch_keys(head="catmlp+dpt"), 0, 0.3)
    with torch.device("meta"):
        model = Mast3rModel(cfg)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith(convert._IGNORED_PREFIXES)}, assign=True)
    model = model.cuda().eval()
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 288, 512, 3)).astype(np.float32)).cuda()
            for _ in range(2))
    call = lambda: model(a, b)
    run = prep_flow.batch_runner(model, 0, a.device, prep_depth.DEPTH_GRAPHS)[0]
    with torch.inference_mode():
        s = in_turns(lambda: run(a, b))
        s_routes = without_cudnn_and_autotuned(call)
        ops = top_ops(call)
    return {"model": "mast3r catmlp+dpt 512x288", "s_per_pair": s, **s_routes,
            "eager_idle_share": 1 - ops["device_busy_ms"] / 1e3 / float(np.median(s["eager"])),
            "top_ops": ops}


def lmeds_split():
    """The eager LMedS's parts on a rigid scene's 854x480 flow, ms between
    CUDA events, and the whole with torch.linalg.eigh in small_eig's place:
    (split, the flow, the draws, x1, x2, the draws' sample indices)."""
    import chip_smoke
    from gflow_tpu_torch.ops import epipolar as ep
    from gflow_tpu_torch.opt.graphs import disable_graphs
    from gflow_tpu_torch.pipeline.prep_moveseg import uv_grid

    H, W = 480, 854
    flow, _ = chip_smoke.scene_flow(H, W)
    x1 = torch.from_numpy(uv_grid(H, W).reshape(-1, 2)).cuda()
    x2 = x1 + torch.from_numpy(np.stack([2 * flow[..., 0] / (W - 1), 2 * flow[..., 1] / (H - 1)],
                                        -1).reshape(-1, 2).astype(np.float32)).cuda()
    draws = ep.lmeds_draws(H * W)
    idx, score_idx = (d.cuda() for d in draws)
    with disable_graphs():
        Fs = ep._solve_f(ep._design_rows(x1[idx], x2[idx]))
        med = ep.median_last(ep.sampson_error(x1[score_idx], x2[score_idx], Fs))
        best = torch.argmin(med).reshape(1)
        sigma2 = (2.5 * 1.4826) ** 2 * med.index_select(0, best)[0]
        inl = ep.sampson_error(x1, x2, Fs.index_select(0, best)[0]) < sigma2

        def score():
            m = ep.median_last(ep.sampson_error(x1[score_idx], x2[score_idx], Fs))
            b = torch.argmin(m).reshape(1)
            return ep.sampson_error(x1, x2, Fs.index_select(0, b)[0]) < m.index_select(0, b)[0]

        split_ms = {
            "draws_copy": event_ms(lambda: [d.cuda() for d in draws]),
            "solve_512": event_ms(lambda: ep._solve_f(ep._design_rows(x1[idx], x2[idx]))),
            "score_sort_inliers": event_ms(score),
            "sort_only": event_ms(lambda: torch.sort(
                ep.sampson_error(x1[score_idx], x2[score_idx], Fs), dim=-1)),
            "refit": event_ms(lambda: ep._solve_f(ep._design_rows(x1, x2) * inl[:, None])),
            "whole_eager": event_ms(lambda: ep.find_fundamental_lmeds(x1, x2, draws=draws)),
        }
        with mock.patch.object(ep, "smallest_eigvec", ep.smallest_eigvec_plain):
            split_ms["whole_eager_with_eigh"] = event_ms(
                lambda: ep.find_fundamental_lmeds(x1, x2, draws=draws))
    return split_ms, flow, draws, x1, x2, idx


def lmeds():
    from gflow_tpu_torch.ops import epipolar as ep
    from gflow_tpu_torch.opt.graphs import disable_graphs
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map

    split_ms, flow, draws, x1, x2, idx = lmeds_split()
    graphed_ms = event_ms(lambda: ep.find_fundamental_lmeds(x1, x2, draws=draws))
    M = ep._design_rows(x1[idx], x2[idx])
    M = M.transpose(-1, -2) @ M
    eig_ms = {"small_eig_512x9x9": event_ms(lambda: ep.small_eig(M)),
              "torch_linalg_eigh_512x9x9": event_ms(lambda: torch.linalg.eigh(M))}
    frame = in_turns(lambda: epipolar_error_map(flow, device="cuda", draws=draws))
    with disable_graphs():
        ops = top_ops(lambda: ep.find_fundamental_lmeds(x1, x2, draws=draws))
    return {"model": "lmeds 854x480", "lmeds_ms": {"eager_split": split_ms,
                                                   "graphed": graphed_ms},
            "eigensolver_ms": eig_ms, "error_map_s_per_frame": frame, "top_ops_eager": ops}


def align():
    from gflow_tpu_torch.models.mast3r import alignment
    from gflow_tpu_torch.opt.graphs import disable_graphs

    rng = np.random.default_rng(0)
    H, W = 288, 512
    preds = {}
    for i, j in alignment.make_pairs_logwin(4, 3):
        pts = lambda: (rng.normal(0, 0.05, (H, W, 3)) + [0, 0, 2]).astype(np.float32)
        conf = (1 + rng.uniform(0, 1, (H, W, 1))).astype(np.float32)
        preds[(i, j)] = ({"pts3d": pts(), "conf": conf}, {"pts3d": pts(), "conf": conf})
    timings = {"graphed": [], "eager": []}
    run = lambda: alignment.global_align(preds, 4, (H, W), device="cuda", collect_timings=True)
    for mode in ("graphed", "eager") + TURNS:
        with disable_graphs() if mode == "eager" else ExitStack():
            t = run()["timings"]
        timings[mode].append(t)
    steps = lambda: alignment.global_align(preds, 4, (H, W), steps1=20, steps2=0, device="cuda")
    with disable_graphs():
        ops = top_ops(steps)
    return {"model": "global_align 10 edges", "timings_first_calls": {
        m: v[0] for m, v in timings.items()}, "timings_in_turns": {
        m: v[1:] for m, v in timings.items()}, "top_ops_20_steps_eager": ops}


def step():
    """The B-frame step in turns at dryrun_step's size and at the fit's
    width (bench.py's frame: 854x480, capacity 51,200, M=8 / K=96, focal
    500 px), with the device time of one eager call and one replay."""
    from gflow_tpu_torch.opt.graphs import disable_graphs
    from gflow_tpu_torch.parallel.mesh import make_mesh
    from gflow_tpu_torch.parallel.multichip import sharded_train_step, step_inputs

    n = torch.cuda.device_count()
    mesh = make_mesh(4, data_parallel=2, device=[torch.device("cuda", i % n) for i in range(4)])

    def timed(**kw):
        cfg, dyn, args = step_inputs(mesh, **kw)
        run = sharded_train_step(mesh, cfg, dyn)[0]
        call = lambda: run(*args)
        ms = {m: [1e3 * s for s in v] for m, v in in_turns(call, reps=10).items()}
        with disable_graphs():
            eager = top_ops(call, n=5)
        return {"ms_per_step": ms, "eager_device_busy_ms": eager["device_busy_ms"],
                "graphed_device_busy_ms": top_ops(call, n=5)["device_busy_ms"],
                "eager_top_kernels": eager["kernels"]}

    return {"model": f"B-frame step, mesh {mesh.shape} over {n} card(s)",
            "dryrun 64x48, 512 points": timed(),
            "fit width 854x480, 51,200 points": timed(
                W=854, H=480, capacity=51_200, max_per_tile=96, max_tiles_per_gaussian=8,
                focal=500.0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="gmflow,mast3r,lmeds,align,step")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name in args.only.split(","):
        print(json.dumps({"gmflow": gmflow, "mast3r": mast3r, "lmeds": lmeds,
                          "align": align, "step": step}[name]()), flush=True)


if __name__ == "__main__":
    main()
