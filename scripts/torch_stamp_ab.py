#!/usr/bin/env python3
"""The stage loop's cost of the device stamps (``ops/stamp.py``), in one
process on one card: the benchmark cell's fit (``bench_h100``'s
``fit-davis480-moving`` driver, its set-up and its frames) with the
trainer's telemetry attached (stamped stages) and detached (unstamped,
as a trainer without telemetry runs), frame by frame in turns (on, off,
off, on). Each stage is timed around ``train_stage`` and its pull to the
host, as ``fit.stage_ms_per_iter`` times it (``device/stage``); both modes'
graphs are recorded before the first timed frame.

    python3 scripts/torch_stamp_ab.py [--rounds 6] [--seed 7] [--device cpu]

Prints the card's name and power limit, each mode's stage ms per
iteration (frame by frame, and the median) and the stamps' pieces, and
writes them to ``chiprun_out/torch_stamp_ab.json``. ``--device cpu`` runs
the benchmark tests' tiny size on the CPU (a smoke run: no timing there
means anything).
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_h100"
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "fit-davis480-moving"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")

    import torch

    import run as bench_run
    from harness import manifest
    from torch_ab import card

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.utils.bgwriter import flush_writes

    bench_run.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = manifest.workload(CELL)
    traffic, config = wl["traffic"], manifest.config(wl["config"])
    if args.device == "cuda":
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
                        tempfile.mkdtemp(prefix="stamp_ab_"))
    try:
        times, pieces = turns(driver, driver.setup(run), args.rounds, sync)
        flush_writes()  # the frames' queued image writes, into run.tmp
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    med = {on: statistics.median(v) for on, v in times.items()}
    row = {"card": name, "seed": args.seed, "rounds": args.rounds,
           "ms_per_iter_on": times[True], "ms_per_iter_off": times[False],
           "median_on": med[True], "median_off": med[False],
           "cost_share": (med[True] - med[False]) / med[False],
           "pieces_ms_per_iter": pieces}
    print(f"# stamps A/B ({row['card']}): stage ms/iter median on {med[True]:.4f}, off "
          f"{med[False]:.4f} ({100 * row['cost_share']:+.2f}%); pieces ms/iter "
          f"{json.dumps({k: round(v, 4) for k, v in pieces.items()})}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_stamp_ab.json").write_text(json.dumps(row, indent=1))
    print(json.dumps(row))
    return 0


def turns(driver, s, rounds: int, sync):
    """The driver's frames in turns, stamped and not: each frame's stage ms
    per iteration by mode, and the stamped frames' pieces in ms per
    iteration."""
    from gflow_tpu_torch.pipeline import trainer as trainer_mod
    from gflow_tpu_torch.utils.profiling import Telemetry

    stages = []  # (stamped, seconds, iterations) of each stage, timed as device/stage
    orig = trainer_mod.train_stage

    def timed(*a, **kw):
        sync()
        t = time.perf_counter()
        out = orig(*a, **kw)
        out[2]["loss_trace"].cpu()  # the stage's pull waits for it, as device/stage's does
        stages.append((a[5].stamps, time.perf_counter() - t, a[5].iterations))
        return out

    trainer_mod.train_stage = timed
    tel = Telemetry()
    times = {True: [], False: []}  # stamps on / off: each frame's stage ms per iteration

    def frame(on: bool):
        s.trainer.telemetry = tel if on else None
        del stages[:]
        driver.fit_frame(s, s.next_frame)
        s.next_frame += 1
        assert all(st == on for st, _, _ in stages)
        times[on].append(1e3 * sum(t for _, t, _ in stages) / sum(n for _, _, n in stages))

    for on in (True, False):  # both modes' graphs recorded
        frame(on)
    for v in times.values():
        v.clear()
    pieces0 = {k: v for k, v in tel.phase_seconds.items() if k.startswith("iter/")}
    its0 = tel.phase_calls.get("iter/render", 0)
    try:
        for _ in range(rounds):
            for on in (True, False, False, True):
                frame(on)
    finally:
        trainer_mod.train_stage = orig
    its = tel.phase_calls["iter/render"] - its0
    pieces = {k: 1e3 * (v - pieces0.get(k, 0.0)) / its for k, v in tel.phase_seconds.items()
              if k.startswith("iter/")}
    return times, pieces


if __name__ == "__main__":
    sys.exit(main())
