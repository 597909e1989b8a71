"""Where the prior preparation's time goes on the card, at the released widths.

    python3 scripts/torch_profile_prep.py [--only gmflow,mast3r,lmeds,align]

Seeded random weights (x0.5 GMFlow, x0.3 MASt3R, as chip_smoke.py). Per
model: the median seconds of a directed pair after one warm-up call, the
seconds of its parts (timed wrappers around the module's functions and
forwards, the card synchronized at each), and torch.profiler's top device
kernels and top aten ops (by the device time of their kernels, with input
shapes) of one call; the models also with cuDNN off and with its
autotuner on. GMFlow runs at
864x480, MASt3R catmlp+dpt at 512x288, the LMedS on a rigid scene's
854x480 flow, global_align's Adam steps on a 10-edge graph of seeded
pointmaps. Prints JSON lines and the card's name and power limit.
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, aten = [], []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key.startswith("aten::"):
            us = _device_us(e, False)
            if us:
                aten.append((us, e.count, e.key, str(e.input_shapes)[:120]))
        else:
            us = _device_us(e, True)
            if us:
                kernels.append((us, e.count, e.key, ""))
    out = {}
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


def gmflow():
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert, gmflow as g

    model = GMFlow(GMFlowConfig()).cuda().eval()
    model.load_state_dict(seeded_state_dict(convert.expected_torch_keys(), 0, 0.5))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 480, 864, 3)).astype(np.float32)).cuda()
            for _ in range(2))
    call = lambda: model(a, b)
    with torch.inference_mode():
        s = median_s(call)
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
            "top_ops": ops}


def mast3r():
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict

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
    with torch.inference_mode():
        s = median_s(call)
        s_routes = without_cudnn_and_autotuned(call)
        ops = top_ops(call)
    return {"model": "mast3r catmlp+dpt 512x288", "s_per_pair": s, **s_routes, "top_ops": ops}


def lmeds():
    import chip_smoke
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map

    flow, _ = chip_smoke.scene_flow(480, 854)
    call = lambda: epipolar_error_map(flow, device="cuda")
    return {"model": "lmeds 854x480", "s_per_frame": median_s(call), "top_ops": top_ops(call)}


def align():
    from gflow_tpu_torch.models.mast3r import alignment

    rng = np.random.default_rng(0)
    H, W = 288, 512
    preds = {}
    for i, j in alignment.make_pairs_logwin(4, 3):
        pts = lambda: (rng.normal(0, 0.05, (H, W, 3)) + [0, 0, 2]).astype(np.float32)
        conf = (1 + rng.uniform(0, 1, (H, W, 1))).astype(np.float32)
        preds[(i, j)] = ({"pts3d": pts(), "conf": conf}, {"pts3d": pts(), "conf": conf})
    run = lambda: alignment.global_align(preds, 4, (H, W), device="cuda", collect_timings=True)
    run()
    t = run()["timings"]
    steps = lambda: alignment.global_align(preds, 4, (H, W), steps1=20, steps2=0, device="cuda")
    return {"model": "global_align 10 edges", "timings": t, "top_ops_20_steps": top_ops(steps)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="gmflow,mast3r,lmeds,align")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name in args.only.split(","):
        print(json.dumps({"gmflow": gmflow, "mast3r": mast3r, "lmeds": lmeds,
                          "align": align}[name]()), flush=True)


if __name__ == "__main__":
    main()
