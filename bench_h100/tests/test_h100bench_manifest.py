"""BENCHMARK.json against the contract's shapes, and every configuration,
cell, driver and per-layer metric found by its name."""
import json
import os
import re

import pytest

from harness import manifest

BENCH = manifest.BENCH
ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "width")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_h100/run.py"]
    assert bench["paths"] == ["bench_h100"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    lines = {"configs": ("why", "source"), "workloads": ("why",), "per_layer": ("layer",),
             "end_to_end": ()}
    for group, keys in lines.items():
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in keys:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got)), group
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_cell_reports_enough(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for c in cells:
        e2e = manifest.metrics_of(bench, c, False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2, c
        assert manifest.metrics_of(bench, c, True), c


def test_per_layer_metrics_name_layer_moves_and_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(manifest.module("metrics", m["name"]).read)


def test_cells_configs_drivers_found_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    fours = 0
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        fours += w["chips"] == 4
        assert w["traffic"] == w["name"]
        wl = manifest.workload(w["name"])
        assert wl["config"] == w["config"] and w["config"] in configs
        used.add(w["config"])
        assert callable(manifest.module("drivers", wl["driver"]).setup)
        assert "limits" in wl["check"]
    assert fours <= max(1, len(bench["workloads"]) // 4)
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_hold_reduced_and_sources(bench):
    files = set()
    for c in bench["configs"]:
        assert c["file"].startswith("bench_h100/") and c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg, key
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
        assert c["source"].startswith("https://")


def test_paths_hold_only_the_benchmark(bench):
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
