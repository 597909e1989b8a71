#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 --seconds 1 \
        [--controls tf32,half] [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up and a short window, as a
run makes them, then the compared numbers of the program against the plain
reference (the lower readings), and, for the seeds in ``--control-seeds``
(all by default), those of each control: the reference itself put in the
program's place, computed in the lower precision, or with a fault planted
(the upper readings). One
JSON line a seed. The benchmark's own runs never run this; ``PERF.md``
gives the readings and the limits set from them.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import run as bench
from harness import manifest
from harness.trace import Tracer


def fresh_caches() -> None:
    """Empty the program's module-level graph caches between seeds, so that
    one seed's graphs do not hold the card's memory for the next."""
    from gflow_tpu_torch.opt import graphs

    for name, mod in list(sys.modules.items()):
        if not name.startswith("gflow_tpu_torch") or mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if type(val) is graphs.ForwardCache:
                setattr(mod, attr, graphs.ForwardCache(val.name, val.maxsize))
            elif type(val) is graphs.GraphCache and attr != "DEFAULT_CACHE":
                setattr(mod, attr, graphs.GraphCache(val.maxsize))


def one_seed(cell: str, seed: int, seconds: float, controls: list[str]) -> dict:
    import torch

    wl = manifest.workload(cell)
    config = manifest.config(wl["config"])
    driver = manifest.module("drivers", wl["driver"])
    tmp = tempfile.mkdtemp(prefix="bench_h100_control_")
    try:
        run = bench.Run(cell, config, wl["traffic"], wl.get("check", {}), seed, "cuda", 1, tmp)
        t = time.time()
        prepared = driver.setup(run)
        win = driver.window(prepared, run, seconds, Tracer(False))
        material = driver.release(prepared)
        del prepared
        torch.cuda.empty_cache()
        out = {"seed": seed, "setup_s": time.time() - t, "e2e": win["e2e"],
               "program": driver.numbers(material, run)}
        for c in controls:
            out[c] = driver.numbers(material, run, c)
        out["info"] = {k: v for k, v in run.info.items()
                       if k.startswith(("check_", "k_escalations", "warm"))}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        fresh_caches()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--controls", default="tf32")
    ap.add_argument("--control-seeds", default=None)
    a = ap.parse_args(argv)
    bench.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gflow_tpu_torch.ops import _build

    _build.build_all()
    seeds = [int(s) for s in a.seeds.split(",")]
    ctrl_seeds = set(seeds if a.control_seeds is None
                     else (int(s) for s in a.control_seeds.split(",")))
    controls = [c for c in a.controls.split(",") if c]
    for seed in seeds:
        rec = one_seed(a.workload, seed, a.seconds, controls if seed in ctrl_seeds else [])
        print(json.dumps(rec, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
