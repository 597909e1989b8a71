#!/usr/bin/env python3
"""The stage loop with the loss's SSIM as its plain version and as the
kernels (``ops/ssim.py``, ``csrc/ssim.cu``), in one process on one card:
the benchmark cell's fit (``bench_h100``'s ``fit-davis480-moving`` driver,
its set-up and its frames), frame by frame in turns (plain, kernels,
kernels, plain), each mode with its own telemetry, so its stamps give the
iteration's pieces (``fit.iter_render_ms``, ``fit.iter_loss_ms``,
``fit.iter_backward_ms``, ``fit.iter_update_ms``, ``fit.between_iters_ms``).
The plain mode swaps ``opt.losses.ssim`` for ``ssim_plain``; the graphs'
key holds the swap, so each mode replays its own graphs, both recorded
before the first timed frame. Each stage is timed around ``train_stage``
and its pull to the host, as ``fit.stage_ms_per_iter`` times it.

    python3 scripts/torch_ssim_ab.py [--rounds 3] [--seed 7] [--device cpu]

Prints the card's name and power limit and, per mode, the stage ms per
iteration (frame by frame, and the median) and the pieces in ms per
iteration, and writes them to ``chiprun_out/torch_ssim_ab.json``.
``--device cpu`` runs the benchmark tests' tiny size on the CPU (a smoke
run: both modes are the plain version there, and no timing means
anything).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_h100"
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "fit-davis480-moving"
MODES = ("plain", "kernels")
TURNS = ("plain", "kernels", "kernels", "plain")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")

    import torch

    import run as bench_run
    from harness import manifest

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.utils.bgwriter import flush_writes

    bench_run.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = manifest.workload(CELL)
    traffic, config = wl["traffic"], manifest.config(wl["config"])
    if args.device == "cuda":
        from torch_ab import card

        _build.build_all()
        sync, name = torch.cuda.synchronize, card()
    else:
        sys.path.insert(0, str(BENCH / "tests"))
        from tiny import TINY

        traffic = bench_run._merged(traffic, TINY[CELL][0])
        config = bench_run._merged(config, TINY[CELL][1])
        sync, name = (lambda: None), "cpu"
    driver = manifest.module("drivers", wl["driver"])
    run = bench_run.Run(CELL, config, traffic, wl.get("check", {}), args.seed, args.device, 1,
                        tempfile.mkdtemp(prefix="ssim_ab_"))
    try:
        times, pieces, launches = turns(driver, driver.setup(run), args.rounds, sync)
        flush_writes()  # the frames' queued image writes, into run.tmp
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    med = {m: statistics.median(v) for m, v in times.items()}
    row = {"card": name, "seed": args.seed, "rounds": args.rounds,
           "ms_per_iter": times, "median_ms_per_iter": med,
           "pieces_ms_per_iter": pieces, "launches_per_frame": launches}
    for m in MODES:
        print(f"# {m} SSIM ({name}): stage ms/iter median {med[m]:.4f} "
              f"({', '.join(f'{t:.4f}' for t in times[m])}); pieces ms/iter "
              f"{json.dumps({k: round(v, 4) for k, v in pieces[m].items()})}; launches a "
              f"frame {json.dumps(launches[m])}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_ssim_ab.json").write_text(json.dumps(row, indent=1))
    print(json.dumps(row))
    return 0


def turns(driver, s, rounds: int, sync):
    """The driver's frames in turns, plain SSIM and kernels: each frame's
    stage ms per iteration by mode, each mode's pieces in ms per iteration
    (its telemetry's ``iter/*`` stamps) and the SSIM launches of its last
    frame."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.ops.ssim import ssim_plain
    from gflow_tpu_torch.opt import losses
    from gflow_tpu_torch.pipeline import trainer as trainer_mod
    from gflow_tpu_torch.utils.profiling import Telemetry

    stages = []  # (seconds, iterations) of each stage, timed as device/stage
    orig = trainer_mod.train_stage

    def timed(*a, **kw):
        sync()
        t = time.perf_counter()
        out = orig(*a, **kw)
        out[2]["loss_trace"].cpu()  # the stage's pull waits for it, as device/stage's does
        stages.append((time.perf_counter() - t, a[5].iterations))
        return out

    trainer_mod.train_stage = timed
    tel = {m: Telemetry() for m in MODES}
    times = {m: [] for m in MODES}
    launches = {}

    def frame(mode: str):
        s.trainer.telemetry = tel[mode]
        del stages[:]
        _build.LAUNCHES.clear()
        swap = (mock.patch.object(losses, "ssim", ssim_plain) if mode == "plain"
                else contextlib.nullcontext())
        with swap:
            driver.fit_frame(s, s.next_frame)
        s.next_frame += 1
        times[mode].append(1e3 * sum(t for t, _ in stages) / sum(n for _, n in stages))
        launches[mode] = {k: v for k, v in _build.LAUNCHES.items() if k.startswith("ssim")}

    for m in MODES:  # both modes' graphs recorded
        frame(m)
    for v in times.values():
        v.clear()
    base = {m: ({k: v for k, v in t.phase_seconds.items() if k.startswith("iter/")},
                t.phase_calls.get("iter/render", 0)) for m, t in tel.items()}
    try:
        for _ in range(rounds):
            for m in TURNS:
                frame(m)
    finally:
        trainer_mod.train_stage = orig
    pieces = {}
    for m, t in tel.items():
        sec0, its0 = base[m]
        its = t.phase_calls["iter/render"] - its0
        pieces[m] = {k: 1e3 * (v - sec0.get(k, 0.0)) / its for k, v in t.phase_seconds.items()
                     if k.startswith("iter/")}
    return times, pieces, launches


if __name__ == "__main__":
    sys.exit(main())
