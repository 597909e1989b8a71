"""The port's spans and counters (gflow_tpu_torch/utils/profiling.py and
where the program records into it), on the CPU: nested phases with their
parents and self times, phases as torch.profiler ranges on the
profiler's clock, the traced part of each phase, the trainer's hull
pieces and the writer's busy seconds beside them, the stage's stamps
(ops/stamp.py; the host's clock on the CPU), the prior preparation's
phases, and the benchmark's readers of all of these
(bench_h100/metrics/).

No JAX here: the frames, the scene and the models are made with NumPy
and the port's seeded weights, at tiny sizes."""
import importlib.util
import json
import os
import runpy
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gflow_tpu_torch.core.io import imwrite
from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel
from gflow_tpu_torch.models.mast3r import convert as mconvert
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
from gflow_tpu_torch.models.unimatch import convert as uconvert
from gflow_tpu_torch.ops import stamp as tstamp
from gflow_tpu_torch.ops.render import RenderConfig
from gflow_tpu_torch.opt import graphs as stage_graphs
from gflow_tpu_torch.opt import train as ttrain
from gflow_tpu_torch.opt.losses import LossWeights
from gflow_tpu_torch.pipeline import prep_depth, prep_flow
from gflow_tpu_torch.pipeline import trainer as trainer_mod
from gflow_tpu_torch.utils import bgwriter, profiling
from gflow_tpu_torch.utils.profiling import Telemetry

ROOT = Path(__file__).resolve().parent.parent
W, H = 48, 32
HULL_PIECES = ("hull/select", "hull/concave", "hull/erode")


def test_nested_phases_record_parent_and_self_time():
    tel = Telemetry()
    with tel.phase("outer"):
        with tel.phase("inner"):
            time.sleep(0.02)
        with tel.phase("inner"):
            time.sleep(0.01)
        time.sleep(0.01)
    with tel.phase("alone"):
        pass
    sec, own = tel.phase_seconds, tel.self_seconds()
    assert tel.phase_parent == {"inner": "outer", "outer": None, "alone": None}
    assert tel.phase_calls["inner"] == 2 and tel.phase_calls["outer"] == 1
    assert sec["outer"] >= sec["inner"] >= 0.03
    assert own["outer"] == pytest.approx(sec["outer"] - sec["inner"])
    assert own["inner"] == sec["inner"] and own["outer"] >= 0.01
    summary = tel.summary()["phases"]
    assert summary["inner"]["parent"] == "outer" and summary["outer"]["parent"] is None
    assert set(summary["outer"]) == {"sec", "calls", "median_sec_per_call", "self_sec",
                                     "parent"}
    tel.add("device/piece", 0.5, 4)
    assert tel.phase_seconds["device/piece"] == 0.5 and tel.phase_calls["device/piece"] == 4
    assert "device/piece" not in tel.phase_parent  # measured elsewhere: no child of any phase


def test_phase_is_a_profiler_range_on_the_profilers_clock():
    """Under a CPU torch.profiler each phase is a "phase:" host range. A
    reading of the phases' clock taken inside a phase lies inside its
    range, and the phase's seconds lie within 1 ms of the range's: the two
    share one clock."""
    tel = Telemetry()
    inside = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.phase("outer"):
            with tel.phase("inner"):
                time.sleep(0.005)
                inside["inner"] = time.time_ns()
                time.sleep(0.005)
            time.sleep(0.005)
            inside["outer"] = time.time_ns()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("phase:")}
    assert set(ranges) == {"phase:outer", "phase:inner"}
    for name, t in inside.items():
        r0, r1 = ranges[profiling.PREFIX + name]
        assert r0 < t < r1, (name, t - r0, r1 - t)
        assert abs(tel.phase_seconds[name] * 1e9 - (r1 - r0)) < 1_000_000, name


def test_traced_seconds_count_only_what_ran_under_the_profiler():
    tel = Telemetry()
    with tel.phase("a"):
        time.sleep(0.002)
    with profile(activities=[ProfilerActivity.CPU]):
        with tel.phase("b"):
            time.sleep(0.002)
        tel.add("c", 0.25)
    with tel.phase("b"):
        time.sleep(0.002)
    assert set(tel.traced_seconds) == {"b", "c"} and tel.traced_seconds["c"] == 0.25
    assert 0 < tel.traced_seconds["b"] < tel.phase_seconds["b"]


def test_profiler_start_through_low_level_calls_is_seen():
    """The benchmark's tracer starts the profiler through its low-level
    calls, which leave torch.autograd.profiler's Python flag unset: a
    phase opens its range all the same."""
    from torch.autograd import (ProfilerActivity as A, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)
    from torch._C._profiler import _ExperimentalConfig

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, {A.CPU})
    _enable_profiler(cfg, {A.CPU})
    tel = Telemetry()
    try:
        assert profiling.profiler_on()
        with tel.phase("low"):
            pass
    finally:
        result = _disable_profiler()
    assert not profiling.profiler_on()
    assert "phase:low" in {e.name() for e in result.events()}
    assert tel.traced_seconds["low"] > 0


def test_no_range_while_the_profiler_is_off(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a) or pytest.fail("range made"))
    tel = Telemetry()
    for _ in range(3):
        with tel.phase("x"):
            with tel.phase("y"):
                pass
    assert not made and not tel.traced_seconds
    assert tel.phase_calls["x"] == tel.phase_calls["y"] == 3


def test_writer_busy_seconds_rise_while_a_job_runs():
    w = bgwriter.BackgroundWriter()
    assert w.busy_s == 0.0
    go = threading.Event()
    w.submit(go.wait)
    time.sleep(0.05)
    mid = w.busy_s
    assert mid > 0.03
    go.set()
    w.flush()
    done = w.busy_s
    assert done >= mid and w.busy_s == done  # idle: it stays put


def flush_within(w, seconds=60):
    """w.flush() with a time limit: a lane that stopped fails the test
    rather than hanging it."""
    box = {}

    def run():
        try:
            w.flush()
        except Exception as e:
            box["err"] = e
        box["done"] = True

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert box.get("done"), "the writer did not drain"
    if "err" in box:
        raise box["err"]


def test_writer_busy_seconds_sum_over_lanes():
    """Two jobs blocked at once on two lanes count their seconds twice."""
    if bgwriter.lane_count() < 2:
        pytest.skip("one usable CPU: the writer runs one lane")
    w = bgwriter.BackgroundWriter()
    started = [threading.Event(), threading.Event()]
    go = threading.Event()
    for i in range(2):
        w.submit_keyed(i, lambda i=i: started[i].set() or go.wait(10))
    try:
        assert started[0].wait(10) and started[1].wait(10)
        t0 = time.perf_counter()
        time.sleep(0.05)
        wait = time.perf_counter() - t0
        mid = w.busy_s
        assert mid >= 2 * wait
    finally:
        go.set()
    flush_within(w)
    assert w.busy_s >= mid


# ---------------------------------------------------------------- the trainer


def scene(seed=0):
    """A textured frame with a square region marked as moving."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 0.05, (H, W, 3))
    img = np.clip(img, 0.02, 0.98).astype(np.float32)
    depth = (1.5 + xx + 0.1 * yy).astype(np.float32)
    move = np.zeros((H, W), bool)
    move[6:26, 12:36] = True
    return img, depth, move


def make_trainer(telemetry: bool):
    img, depth, move = scene()
    tr = trainer_mod.GFlowTrainer(gt_image=img, gt_depth=depth, num_points=300,
                                  make_logs=False, device="cpu", seed=1,
                                  render_config=RenderConfig(max_per_tile=64,
                                                             max_tiles_per_gaussian=16))
    tr.k_escalate_threshold = None
    tr.init_gaussians_from_image(img, depth)
    tr.telemetry = Telemetry() if telemetry else None
    return tr, move


@pytest.fixture
def stage_configs(monkeypatch):
    """The StageConfig of every stage the trainer runs."""
    seen = []
    orig = trainer_mod.train_stage

    def recorded(*args, **kw):
        seen.append(args[5])
        return orig(*args, **kw)

    monkeypatch.setattr(trainer_mod, "train_stage", recorded)
    return seen


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trainer_stamps_pieces_and_names_hull_pieces_outside_host(stage_configs, one_thread):
    """A traced trainer's full stage: the stamps are monotone within each
    iteration, every piece is non-negative and all of them sum to no more
    than the stage's wall time; the hull's pieces are phases inside
    host/hull_seg whose names leave fit.host_s_per_frame's sum of host/*
    phases as it was."""
    tr, move = make_trainer(telemetry=True)
    tr.train(iterations=6, lr=1e-2, move_mask=move)
    tel = tr.telemetry
    assert stage_configs[-1].stamps
    table = tr._last_info["stamps"].numpy()
    assert table.shape == (6, tstamp.COLS) and (table > 0).all()
    assert (np.diff(table, axis=1) >= 0).all() and (table[1:, 0] >= table[:-1, -1]).all()
    pieces = {k[len("iter/"):]: v for k, v in tel.phase_seconds.items()
              if k.startswith("iter/")}
    assert set(pieces) == {*tstamp.PIECES, "between"}
    assert all(v >= 0 for v in pieces.values())
    assert sum(pieces.values()) <= tel.phase_seconds["device/stage"]
    assert tel.phase_calls["iter/render"] == 6 and tel.phase_calls["iter/between"] == 5
    assert pieces == pytest.approx(tstamp.pieces(table))

    inside = {k for k, p in tel.phase_parent.items() if p == "host/hull_seg"}
    assert inside == set(HULL_PIECES)
    assert not any(k.startswith("host/") for k in inside)
    # every host/* phase is a top-level one here: none is counted inside another
    assert all(tel.phase_parent[k] is None for k in tel.phase_seconds
               if k.startswith("host/") and k in tel.phase_parent)
    assert "writer/busy_in_hull" in tel.phase_seconds


def test_writer_busy_in_hull_rises_with_a_slow_job(one_thread):
    tr, move = make_trainer(telemetry=True)
    tr.train(iterations=2, lr=1e-2, move_mask=move)
    assert tr.telemetry.phase_seconds["writer/busy_in_hull"] == 0.0  # nothing queued
    go = threading.Event()
    bgwriter.get_writer().submit(go.wait)
    try:
        tr.train(iterations=2, lr=1e-2, move_mask=move)
    finally:
        go.set()
        bgwriter.flush_writes()
    tel = tr.telemetry
    busy = tel.phase_seconds["writer/busy_in_hull"]
    assert 0 < busy <= tel.phase_seconds["host/hull_seg"]
    assert tel.phase_calls["writer/busy_in_hull"] == 2


def test_stage_pngs_through_the_lanes_equal_serial_writes(tmp_path, monkeypatch, one_thread):
    """The PNGs two stages of one frame write through the writer's lanes
    (the second overwriting the first's files) are, byte for byte, the
    last array queued for each path written by imwrite on this thread."""
    tr, move = make_trainer(telemetry=False)
    tr.dir = str(tmp_path / "log")
    queued = {}
    submit = bgwriter.BackgroundWriter.submit_keyed

    def spy(self, key, fn, path, arr):
        queued[path] = np.array(arr)
        submit(self, key, fn, path, arr)

    monkeypatch.setattr(bgwriter.BackgroundWriter, "submit_keyed", spy)
    tr.train(iterations=2, lr=1e-2, move_mask=move, save_imgs=True, ckpt_name="00000")
    tr.train(iterations=2, lr=1e-2, move_mask=move, save_imgs=True, ckpt_name="00001",
             camera_only=True)
    tr.train(iterations=2, lr=1e-2, move_mask=move, save_imgs=True, ckpt_name="00001")
    flush_within(bgwriter.get_writer())
    written = sorted(str(p) for p in (tmp_path / "log").rglob("*.png"))
    assert written == sorted(queued) and len(written) >= 2 * 6
    for i, (path, arr) in enumerate(sorted(queued.items())):
        serial = tmp_path / f"serial{i}.png"
        imwrite(serial, arr)
        assert Path(path).read_bytes() == serial.read_bytes(), path


def test_writer_busy_and_backlog_once_per_image_saving_stage(tmp_path, monkeypatch,
                                                             one_thread):
    """writer/busy and writer/backlog are recorded at the end of each stage
    that saved images and of no other; writer/busy sums the writer's busy
    seconds since the telemetry's first stage."""
    tr, move = make_trainer(telemetry=True)
    tr.dir = str(tmp_path / "log")
    tel = tr.telemetry
    counts = []
    monkeypatch.setattr(tel, "count", lambda name, n=1: counts.append((name, n)))
    flush_within(bgwriter.get_writer())
    busy0 = bgwriter.writer_busy_s()
    tr.train(iterations=2, lr=1e-2, move_mask=move, save_imgs=True, ckpt_name="00000")
    tr.train(iterations=2, lr=1e-2, move_mask=move)
    flush_within(bgwriter.get_writer())
    tr.train(iterations=2, lr=1e-2, move_mask=move, save_imgs=True, ckpt_name="00001")
    assert tel.phase_calls["writer/busy"] == 2
    assert [name for name, _ in counts] == ["writer/backlog"] * 2
    assert all(0 <= n <= 10 for _, n in counts)  # at most the stage's 10 files queued
    flush_within(bgwriter.get_writer())
    assert 0 <= tel.phase_seconds["writer/busy"] <= bgwriter.writer_busy_s() - busy0


def test_no_stamps_without_telemetry(stage_configs, one_thread):
    """A trainer without telemetry runs unstamped stages and allocates no
    stamp table; the stamped configuration is another graph cache key."""
    tr, move = make_trainer(telemetry=False)
    tr.train(iterations=2, lr=1e-2, move_mask=move)
    assert not stage_configs[-1].stamps and "stamps" not in tr._last_info
    cfg = stage_configs[-1]
    buf = ttrain._StageBuffers.of(
        dict(params=tr.params, state=tr.state, targets=tr._targets(), intr=tr.intr,
             n_alive=tr.state.n_alive, lrs=torch.zeros(2, 3), flow_prior=None), cfg)
    assert buf.stamps is None
    stamped = ttrain.StageConfig(**{**vars(cfg), "stamps": True})
    dev, weights = torch.device("cpu"), LossWeights()
    assert (stage_graphs.stage_key(cfg, tr.capacity, dev, weights)
            != stage_graphs.stage_key(stamped, tr.capacity, dev, weights))
    assert ttrain._StageBuffers.of(
        dict(params=tr.params, state=tr.state, targets=tr._targets(), intr=tr.intr,
             n_alive=tr.state.n_alive, lrs=torch.zeros(2, 3), flow_prior=None),
        stamped).stamps.shape == (2, tstamp.COLS)


def test_stamp_pieces_arithmetic():
    table = np.array([[10, 12, 15, 20, 21], [30, 31, 33, 37, 40]], np.int64)
    got = tstamp.pieces(table)
    assert got == pytest.approx({"render": 3e-9, "loss": 5e-9, "backward": 9e-9,
                                 "update": 4e-9, "between": 9e-9})
    assert tstamp.pieces(np.zeros((0, tstamp.COLS), np.int64)) == {}
    it, t = torch.tensor([1]), torch.zeros((2, tstamp.COLS), dtype=torch.int64)
    tstamp.stamp(it, t, 3)
    tstamp.stamp(torch.tensor([2]), t, 0)  # past the table: not written
    assert t[1, 3] > 0 and int((t != 0).sum()) == 1


# ---------------------------------------------------------- the prior stages


def write_frames(d, n=4, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    base = rng.uniform(0, 255, (h, w + 2 * n, 3)).astype(np.uint8)
    for t in range(n):
        imwrite(os.path.join(d, f"{t:05d}.png"), base[:, t * 2: t * 2 + w])
    return str(d)


@pytest.fixture
def fresh_current(monkeypatch):
    monkeypatch.setattr(profiling, "_current", None)
    return profiling.current


def test_prep_mains_record_their_phases(tmp_path, fresh_current, monkeypatch, one_thread):
    """prep_flow, prep_moveseg (through its CLI, which writes the
    telemetry beside its masks) and prep_depth record their root phase and
    its pieces into the process's telemetry."""
    seq = write_frames(tmp_path / "seq")
    flow = GMFlow(GMFlowConfig(feature_channels=32, num_transformer_layers=1,
                               num_reg_refine=1, attn_splits_list=(2, 4)))
    flow.load_state_dict(seeded_state_dict(uconvert.expected_torch_keys(1, 32, 4), seed=0,
                                           scale=0.5), strict=True)
    prep_flow.main(seq, model=flow, device="cpu")
    monkeypatch.setattr(sys, "argv", ["prep_moveseg", "--img-dir", seq, "--device", "cpu"])
    runpy.run_module("gflow_tpu_torch.cli.prep_moveseg", run_name="__main__")
    sd = seeded_state_dict(mconvert.expected_torch_keys(1, 2, 32, 16, 8, "linear", 4), seed=0,
                           scale=0.3)
    mast3r = Mast3rModel(Mast3rConfig(patch_size=8, enc_dim=32, enc_depth=1, enc_heads=4,
                                      dec_dim=16, dec_depth=2, dec_heads=4, desc_dim=4,
                                      head="linear", with_desc=False))
    mast3r.load_state_dict({k: v for k, v in sd.items() if "refinenet4.resConfUnit1" not in k},
                           strict=True)
    prep_depth.main(seq, model=mast3r, inference_size=48, winsize=2, device="cpu")

    tel = fresh_current()
    pieces = {"prep_flow": ("load", "forward", "check", "write"),
              "prep_moveseg": ("read", "lmeds", "morph", "write"),
              "prep_depth": ("load", "pairs", "align_host", "align_refine", "write")}
    for root, names in pieces.items():
        assert tel.phase_parent[root] is None and tel.phase_calls[root] == 1
        for n in names:
            assert tel.phase_parent[f"{root}/{n}"] == root, (root, n)
        assert {k for k, p in tel.phase_parent.items() if p == root} == {
            f"{root}/{n}" for n in names}
        assert 0 <= tel.self_seconds()[root] < tel.phase_seconds[root]
    assert tel.phase_calls["prep_moveseg/morph"] == 3  # one a pair
    assert tel.phase_calls["prep_depth/align_host"] == 2  # before and after the refinement
    dumped = json.load(open(seq + "_epipolar/telemetry.json"))
    assert dumped["phases"]["prep_moveseg/lmeds"]["parent"] == "prep_moveseg"


# ------------------------------------------------------ the benchmark readers


def reader(name):
    path = ROOT / "bench_h100" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


FIT_READERS = {  # metric: (telemetry key, per, scale)
    "fit.iter_render_ms": ("iter/render", "iterations", 1e3),
    "fit.iter_loss_ms": ("iter/loss", "iterations", 1e3),
    "fit.iter_backward_ms": ("iter/backward", "iterations", 1e3),
    "fit.iter_update_ms": ("iter/update", "iterations", 1e3),
    "fit.between_iters_ms": ("iter/between", "iterations", 1e3),
    "fit.hull_concave_s_per_frame": ("hull/concave", "frames", 1.0),
    "fit.hull_erode_s_per_frame": ("hull/erode", "frames", 1.0),
    "fit.hull_writer_busy_s_per_frame": ("writer/busy_in_hull", "frames", 1.0),
    "fit.writer_busy_s_per_frame": ("writer/busy", "frames", 1.0),
}
PREP_READERS = {
    "prep.depth_align_host_s_per_frame": "prep_depth/align_host",
    "prep.depth_write_s_per_frame": "prep_depth/write",
    "prep.moveseg_morph_s_per_frame": "prep_moveseg/morph",
}


@pytest.mark.parametrize("name", sorted(FIT_READERS))
def test_fit_reader(name):
    key, per, scale = FIT_READERS[name]
    read = reader(name)
    assert read({}) is None
    assert read({"telemetry": {"device/stage": 3.0}, "iterations": 450, "frames": 1}) is None
    r = {"telemetry": {key: 0.9, "device/stage": 3.0}, "iterations": 450, "frames": 3}
    assert read(r) == pytest.approx(scale * 0.9 / r[per])


@pytest.mark.parametrize("name", sorted(PREP_READERS))
def test_prep_reader(name, fresh_current):
    read = reader(name)
    assert read({}) is None
    assert read({"traced": {"frames": 16}}) is None  # nothing traced
    tel = fresh_current()
    tel.traced_seconds[PREP_READERS[name]] = 0.8
    assert read({}) is None
    assert read({"traced": {"frames": 16}, "frames": 32}) == pytest.approx(0.05)


def test_benchmark_lists_every_new_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in (*FIT_READERS, *PREP_READERS):
        m = per_layer[name]
        assert (ROOT / "bench_h100" / "metrics" / f"{name}.py").exists()
        cell = "fit-davis480-moving" if name.startswith("fit.") else "prep-davis480-seq16"
        assert m["workloads"] == [cell]
        assert m["moves"] == ("fit_s_per_frame" if name.startswith("fit.")
                              else "prep_s_per_frame")
