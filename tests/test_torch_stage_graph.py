"""The stage's CUDA-graph machinery, on the CPU (opt/graphs.py and the loop
of opt/train.py): the per-stage lr schedule, Adam's device step, the densify
uniforms drawn up front, the graph cache's key and bound, the launch
accounting of replays, and train_stage run through the graph runner with a
fake capture against the eager loop.

Tolerances: none; every comparison is exact (the same float32 arithmetic,
the same draws, the same operations in the same order)."""
import dataclasses

import numpy as np
import pytest
import torch

from gflow_tpu_torch.ops import _build, binning, composite, cuda_raster
from gflow_tpu_torch.ops.render import RenderConfig
from gflow_tpu_torch.opt import graphs as stage_graphs
from gflow_tpu_torch.opt import state as tstate
from gflow_tpu_torch.opt import train as ttrain
from gflow_tpu_torch.opt.losses import LossWeights

import test_torch_train as T


def host_lrs(i, iterations, lr, lr_camera, post_densify):
    """The eager stage's per-iteration learning rates, as it computed them
    on the host (the port's opt/train.py before the schedule tensor)."""
    factor = float(np.float32(1.0) - np.float32(0.9) * np.float32(i) / np.float32(iterations))
    lr, lr_cam = float(np.float32(lr)), float(np.float32(lr_camera))
    if post_densify:
        return (lr, 0.0, 0.0)
    return (float(np.float32(lr * factor)), float(np.float32(lr_cam * factor)),
            float(np.float32(lr * factor)))


@pytest.mark.parametrize("lr,lr_camera", [(1e-2, 1e-3), (0.0137, 0.0)])
@pytest.mark.parametrize("iterations,densify", [(300, {}), (7, {}),
                                                (300, dict(densify_occ=True)),
                                                (40, dict(densify_interval=9, densify_times=3))])
def test_lr_schedule_equals_host_arithmetic(iterations, densify, lr, lr_camera):
    """Every row of the schedule tensor equals the host's float32
    arithmetic for that iteration bit for bit: before the first densify
    event without post_densify, after it with."""
    cfg = ttrain.StageConfig(W=32, H=16, iterations=iterations, **densify)
    dyn = ttrain.StageDynamics(lr=lr, lr_camera=lr_camera)
    rows = ttrain.lr_schedule(cfg, dyn)
    assert rows.dtype == torch.float32 and rows.shape == (iterations, 3)
    events = ttrain._densify_events(cfg)
    first = events[0][1] if events else iterations
    for i in range(iterations):
        want = torch.tensor(host_lrs(i, iterations, lr, lr_camera, i > first),
                            dtype=torch.float32)
        assert torch.equal(rows[i], want), (i, rows[i], want)
    assert (first < iterations) == bool(densify)


def test_adam_device_step_equals_host_step():
    """adam_update with the step kept on the device equals the update with
    a Python step (bias corrections from torch.full((), step)), bit for
    bit, over 10 steps, with float and 0-d tensor learning rates."""
    def host_adam(params, grads, m, v, step, lrs, b1=0.9, b2=0.999, eps=1e-8):
        t = torch.full((), step, dtype=torch.float32)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
        v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
        p = [x - lrs[grp] * (a / bc1) / (torch.sqrt(b / bc2) + eps)
             for x, a, b, grp in zip(params, m, v, tstate.PARAM_GROUPS)]
        return p, m, v

    rng = np.random.default_rng(0)
    p, *_ = T.start(1)
    params = tstate.Params(*(torch.from_numpy(p[k]) for k in tstate.Params._fields))
    opt = tstate.init_opt_state(params)
    hp, hm, hv = list(params), list(opt.m), list(opt.v)
    for step in range(1, 11):
        grads = tstate.Params(*(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
                                for x in params))
        lrs = ttrain.lr_schedule(ttrain.StageConfig(W=32, H=16, iterations=10),
                                 ttrain.StageDynamics(lr=1e-2, lr_camera=1e-3))[step - 1]
        params, opt = tstate.adam_update(params, grads, opt, *lrs)
        hp, hm, hv = host_adam(hp, grads, hm, hv, step, [float(x) for x in lrs])
        assert opt.step.dtype == torch.int32 and int(opt.step) == step
        for got, want in zip((*params, *opt.m, *opt.v), (*hp, *hm, *hv)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("n_events", [0, 1, 3])
def test_densify_uniforms_equal_per_event_draws(n_events):
    """The stage's densify uniforms, drawn up front, are the numbers that
    one draw per event from the same seeded generator gives, in order; the
    generator ends where the per-event draws leave it."""
    up_front, per_event = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    u = ttrain.densify_uniforms(up_front, 64, n_events)
    assert u.shape == (n_events, 64)
    for k in range(n_events):
        assert torch.equal(u[k], torch.rand(64, generator=per_event))
    assert torch.equal(torch.rand(8, generator=up_front), torch.rand(8, generator=per_event))


class FakeGraph:
    """CapturedGraph's protocol without a card: the warm-up runs fn on
    scratch copies of the buffers; the capture records fn; a replay runs
    the recorded fn on the buffers and writes its results into the outputs
    of the first replay, which stay the same tensors, as a graph's static
    outputs do."""

    captures = 0

    def __init__(self, fn, buffers, dev, devices=(), pool=None):
        FakeGraph.captures += 1
        fn(buffers.scratch())
        self.fn, self.buffers, self.outputs = fn, buffers, None

    def replay(self):
        res = self.fn(self.buffers)
        if self.outputs is None:
            self.outputs = res
        else:
            stage_graphs.copy_into(self.outputs, res)


def key(cfg=ttrain.StageConfig(W=32, H=16, iterations=2), capacity=64,
        weights=LossWeights()):
    return stage_graphs.stage_key(cfg, capacity, torch.device("cpu"), weights)


def test_graph_cache_key_and_bound(monkeypatch):
    """A different StageConfig, capacity, loss weights, plain versions or
    deterministic algorithms give a different entry; the same ones the same
    entry; the cache keeps the 32 most recently used."""
    cfg = ttrain.StageConfig(W=32, H=16, iterations=2)
    variants = [key(),
                key(dataclasses.replace(cfg, iterations=3)),
                key(dataclasses.replace(cfg, render=RenderConfig(max_per_tile=96))),
                key(capacity=128),
                key(weights=LossWeights(depth=0.1))]
    with monkeypatch.context() as m:
        m.setattr(cuda_raster, "packed_composite", composite.composite_packed)
        m.setattr(binning, "bin_tail", binning.bin_tail_plain)
        variants.append(key())
    torch.use_deterministic_algorithms(True)
    try:
        variants.append(key())
    finally:
        torch.use_deterministic_algorithms(False)
    assert key() == variants[0]
    assert len(set(variants)) == len(variants)

    made = []

    def make():
        made.append(1)
        return object()

    cache = stage_graphs.GraphCache(capture=FakeGraph)
    entries = [cache.entry(k, make, torch.device("cpu")) for k in variants]
    assert len(made) == len(variants) == len(cache.entries)
    assert all(cache.entry(k, make, torch.device("cpu")) is e for k, e in zip(variants, entries))
    assert len(made) == len(variants)  # hits make nothing

    cache = stage_graphs.GraphCache(capture=FakeGraph)
    keys = [key(capacity=64 * (j + 1)) for j in range(33)]
    for k in keys[:32]:
        cache.entry(k, make, torch.device("cpu"))
    cache.entry(keys[0], make, torch.device("cpu"))  # the first is now the most recent
    cache.entry(keys[32], make, torch.device("cpu"))
    assert len(cache.entries) == stage_graphs.MAX_ENTRIES == 32
    assert keys[0] in cache.entries and keys[1] not in cache.entries


def test_replayed_launches_count_the_recording():
    """Launches made inside recording() are logged, not counted; each
    replay of the log counts every launch once and tells the hooks."""
    _build.LAUNCHES.clear()
    _build.REPLAYED.clear()
    seen = []
    _build.LAUNCH_HOOKS.append(lambda name, args: seen.append((name, args)))
    try:
        with _build.recording() as log:
            _build.count_launch("bin_tail", ((100,), (100,), 0, 8, (12,), (12, 64), 100, 12, 64,
                                             20))
            _build.count_launch("composite_fwd", ((12,), (12, 64, 10), (4,), (12, 256, 4), 12,
                                                  64, 10, 4, 4, 0))
            _build.count_launch("composite_bwd", ((12,), (12, 64, 10), (4,), (12, 256, 4),
                                                  (12, 64, 10), 12, 64, 10, 4, 4, 0))
        assert not _build.LAUNCHES and not seen and len(log) == 3
        for _ in range(5):
            _build.replay_launches(log)
        assert _build.LAUNCHES == {"bin_tail": 5, "composite_fwd": 5, "composite_bwd": 5}
        assert _build.REPLAYED == _build.LAUNCHES and seen == log * 5
    finally:
        _build.LAUNCH_HOOKS.pop()
        _build.LAUNCHES.clear()
        _build.REPLAYED.clear()


@pytest.fixture
def one_thread():
    """One intra-op thread: the exact comparisons below then hold however
    loaded the machine is (a library kernel may split its work by the
    threads it gets)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", ["lean", "rebin", "snapshot"])
def test_graph_runner_stage_equals_eager(monkeypatch, one_thread, path):
    """train_stage through the graph runner (a fake capture; the CPU taken
    for a card) equals the eager stage bit for bit, each path with densify
    events, on two frames in turn through one cache entry: the second
    frame's inputs are copied into the buffers the first one's graphs
    were recorded on."""
    kw = {"lean": dict(densify_occ=True, densify_interval=3, densify_times=2, max_densify=32),
          "rebin": dict(rebin_every=3, densify_interval=4, densify_times=1, max_densify=16),
          "snapshot": dict(snapshot_every=3, densify_occ=True, densify_interval=4,
                           densify_times=1, max_densify=16)}[path]
    cfg = ttrain.StageConfig(W=T.W, H=T.H, iterations=8, render=RenderConfig(**T.RC), **kw)
    dyn = ttrain.StageDynamics(weights=LossWeights(**T.WEIGHTS), lr=1e-2, lr_camera=1e-3,
                               num_points=300, densify_occ_percent=0.5)

    def stage(seed, cache=None):
        p, s, tg, intr = T.start(seed)
        return ttrain.train_stage(*T.torch_side(p, s, tg), torch.from_numpy(intr),
                                  torch.Generator().manual_seed(seed), cfg, dyn,
                                  device="cpu", graphs=cache)

    eager = [stage(seed) for seed in (2, 3)]
    monkeypatch.setattr(stage_graphs, "graphed", lambda dev: True)
    cache = stage_graphs.GraphCache(capture=FakeGraph)
    FakeGraph.captures = 0
    stage_graphs.REPLAYS.clear()
    graphed = [stage(seed, cache) for seed in (2, 3)]
    assert len(cache.entries) == 1
    assert FakeGraph.captures == {"lean": 1, "rebin": 2, "snapshot": 2}[path]
    n_snap = 3 if path == "snapshot" else 0
    n_rebin = 4 if path == "rebin" else 0  # iterations 0, 3, 6 and after the densify
    want = {"step": 16, "rebin": 2 * n_rebin, "snapshot": 2 * n_snap}
    assert dict(stage_graphs.REPLAYS) == {k: v for k, v in want.items() if v}
    for (pe, se, ie), (pg, sg, ig) in zip(eager, graphed):
        for a, b in zip((*pe, *se), (*pg, *sg)):
            assert torch.equal(a, b)
        assert set(ie) == set(ig)
        for k in ie:
            want, got = ie[k], ig[k]
            if isinstance(want, dict):
                assert set(want) == set(got) and all(torch.equal(want[m], got[m]) for m in want)
            else:
                assert torch.equal(want, got), k
