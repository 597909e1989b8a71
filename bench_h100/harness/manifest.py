"""Everything the runner finds by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py`` beside this package."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]   # bench_h100/
ROOT = BENCH.parent                           # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """A cell's file: {"config", "driver", "traffic": {...}}."""
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def module(kind: str, name: str):
    """drivers/<name>.py or metrics/<name>.py, loaded from its file (a
    metric's name holds dots, so it is no import path)."""
    path = BENCH / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_h100_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, cell: str, default: dict | None = None) -> dict:
    """The cell's entry in BENCHMARK.json; `default` for a cell whose file
    exists but that BENCHMARK.json does not list (yet)."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    if default is not None:
        return default
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those that list the cell, or list no cells at all (end-to-end
    only; a per-layer metric without a list reports in every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
