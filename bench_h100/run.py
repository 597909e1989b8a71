#!/usr/bin/env python3
"""The port's H100 benchmark: one run of one cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``gflow_tpu_torch``).
The cell's file (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``) and its
traffic parameters. The driver sets the program up from the seed (weights,
inputs, every shape warmed up), drives it for ``--seconds`` seconds, and
hands back what the window did; once the window has closed the runner reads
the peak device memory, lets the driver free the program's state, and the
driver compares what the timed path produced with the plain reference under
``reference/``. With ``--trace 1`` the driver traces a part of its window
with torch.profiler and the runner reads each per-layer metric through its
reader ``metrics/<metric>.py``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers are the last lines on standard error. A run without
enough cards, or whose process holds the JAX package once the window has
closed, exits nonzero and prints no result.

Build and kernel caches stay inside the checkout: the port builds its
kernels into its fixed ``gflow_tpu_torch/_build/``, and Triton's and
torch's extension caches are pointed at ``.bench_cache/``. Run data goes
to a fresh directory under ``$TMPDIR``, deleted at exit.
"""
from __future__ import annotations

import time

T_START = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import device as hdevice  # noqa: E402
from harness import guard, manifest  # noqa: E402
from harness.spans import Spans  # noqa: E402
from harness.trace import Tracer, breakdown  # noqa: E402


class Run:
    """What a driver is handed: the cell's configuration, traffic and check
    limits, the seed, the device, a private scratch directory, the spans,
    and ``info`` for the run's earlier lines."""

    def __init__(self, cell, config, traffic, check, seed, device, chips, tmp):
        self.cell, self.config, self.traffic, self.check = cell, config, traffic, check
        self.seed, self.device, self.chips, self.tmp = seed, device, chips, tmp
        self.spans = Spans()
        self.info = {}

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def cache_env() -> None:
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def build_kernels(run: Run) -> None:
    """The port's kernels, built by nvcc on the first run in a checkout
    (recorded apart: ``build_s`` and whether any library was missing)."""
    from gflow_tpu_torch.ops import _build

    missing = [s for s in {s for s, _, _ in _build.KERNELS.values()}
               if not _build._lib_path(s).exists()]
    t = time.time()
    _build.build_all()
    run.info["build"] = {"first_build": bool(missing), "seconds": time.time() - t,
                         "missing": sorted(missing)}


def _proc_io() -> dict:
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (ln.split(":") for ln in f if ":" in ln)}
    except OSError:
        return {}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             traffic_overrides: dict | None = None, config_overrides: dict | None = None,
             chips: int | None = None) -> dict:
    """One run of `cell`: the result record (the last line's object).
    `device` and the overrides exist for the CPU tests, which drive a whole
    run at a tiny size."""
    import torch

    bench = manifest.benchmark()
    wl = manifest.workload(cell)
    entry = manifest.cell_entry(bench, cell, default={"chips": 1})
    config = _merged(manifest.config(wl["config"]), config_overrides)
    traffic = _merged(wl["traffic"], traffic_overrides)
    chips = entry["chips"] if chips is None else chips
    driver = manifest.module("drivers", wl["driver"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tmp = tempfile.mkdtemp(prefix="bench_h100_")
    run = Run(cell, config, traffic, wl.get("check", {}), seed, device, chips, tmp)
    io0 = _proc_io()
    try:
        if device == "cuda":
            run.info["smi"] = hdevice.smi()
            build_kernels(run)
        from harness.counters import count_captures

        captures = count_captures()
        prepared = driver.setup(run)
        setup_s = time.time() - T_START
        run.log(f"set-up {setup_s:.3f} s; window {seconds} s")
        tracer = Tracer(trace, run.spans)
        win = driver.window(prepared, run, seconds, tracer)
        found = guard.forbidden_modules()
        if found:
            raise SystemExit(f"the process holds {found} after the window")
        peak = (max(torch.cuda.max_memory_allocated(d) for d in range(chips))
                if device == "cuda" else 0)
        material = driver.release(prepared)
        del prepared
        if device == "cuda":
            torch.cuda.empty_cache()
        t = time.time()
        checks = driver.check(material, run)
        run.info["check_s"] = time.time() - t
        run.info["graph_captures"] = captures()
        run.info["disk"] = {"run_dir_bytes": _dir_bytes(tmp),
                            "process_write_bytes": _proc_io().get("write_bytes", 0)
                            - io0.get("write_bytes", 0)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    if not trace:
        e2e = {m["name"]: m for m in manifest.metrics_of(bench, cell, False)}
        for name, m in e2e.items():
            value = setup_s if name == "setup_s" else win["e2e"].get(name)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        r = dict(win.get("layer", {}), trace=tracer.summary, spans=dict(run.spans.seconds),
                 span_calls=dict(run.spans.calls), window_s=win["window_s"])
        for m in manifest.metrics_of(bench, cell, True):
            value = manifest.module("metrics", m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": peak}
    if trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary["busy_s"]
        dev["window_s"] = tracer.summary["window_s"]
    record = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        record["breakdown"] = breakdown(tracer.summary)
    record["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    run.info.update(setup_s=setup_s, window_s=win["window_s"], memory_peak_bytes=peak,
                    trace_reduce_s=(tracer.summary or {}).get("reduce_s"))
    record["_info"] = run.info
    return record


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    manifest.check_name(args.workload)
    cache_env()
    import torch

    bench = manifest.benchmark()
    need = manifest.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] the cell needs {need} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    record = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    info = record.pop("_info")
    print("[bench] info " + json.dumps(info, default=str), flush=True)
    found = guard.forbidden_modules()
    if found:
        print(f"[bench] the process holds {found}: no result", file=sys.stderr)
        return 4
    for name, c in record["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
