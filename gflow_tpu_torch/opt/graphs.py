"""The stage as CUDA graphs: the counterpart of the JAX package's compiled
stage.

``gflow_tpu/opt/train.py`` runs a stage as jitted ``lax.fori_loop``s split
at the static densify events (:536-551) and its snapshot path as a
``lax.scan`` over chunks (:555-588); ``gflow_tpu/pipeline/trainer.py:52-58``
keeps one compiled stage per ``StageConfig`` (an ``lru_cache(maxsize=32)``
over ``jax.jit``). Here, on a CUDA device, ``opt.train.train_stage`` runs
each piece of its loop body (an iteration, a rebinning, a snapshot) as the
replay of a CUDA graph recorded once per static configuration, and densify
runs eagerly between replays, as ``apply_densify`` runs between the
``fori_loop``s.

- ``StageGraphs`` is one cache entry: the static buffers of one key and the
  graphs recorded on them, by name. A graph is recorded at its first use
  (``CapturedGraph``): its function runs ``WARMUP`` times on scratch copies
  of the buffers on a side stream, so that lazy initialisation happens
  outside the capture and the buffers stay as they were, then once under
  capture on the buffers themselves. A replay reads and writes the
  buffers in place; what the function returned is the graph's static
  output, rewritten by every replay.
- ``GraphCache`` holds at most ``MAX_ENTRIES`` entries, the least recently
  used leaving first, under ``stage_key``: the configuration, the capacity,
  the device, the loss weights (numbers a capture bakes in) and
  ``recording_context()``.
- Launch accounting: a capture logs its kernel launches instead of
  counting them (``_build.recording``), and every replay counts the log
  into ``_build.LAUNCHES``; the warm-up's launches, on scratch data, are
  kept apart (``CapturedGraph.warmup_launches``). ``REPLAYS`` counts the
  replays per graph name.
- ``disable_graphs()``, the counterpart of ``jax.disable_jit()``, runs the
  stage eagerly on the card, for comparison runs. Nothing falls back to
  it: a capture or a replay that fails raises.

A replay runs the eager stage's kernels in its order, so under
deterministic algorithms it gives the eager stage's numbers exactly.
Outside them the gather's transpose (``index_add_``) sums with float
atomics, and any two runs, replayed or eager, differ by rounding.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from ..ops import _build

MAX_ENTRIES = 32
WARMUP = 2  # eager runs on scratch copies before a capture
# replays per graph name since the last reset (``REPLAYS.clear()``)
REPLAYS: collections.Counter = collections.Counter()
_eager = 0  # depth of disable_graphs() blocks


@contextlib.contextmanager
def disable_graphs():
    """Run stages eagerly on the card inside the block: the counterpart of
    ``jax.disable_jit()``, for comparison runs."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


def graphed(dev: torch.device, cfg) -> bool:
    """Whether a stage of `cfg` on `dev` runs as CUDA graphs: on a CUDA
    device, outside ``disable_graphs()``, and not in the tile-band mode
    (``cfg.render.band_devices``), whose bands run on several devices'
    streams and stay eager."""
    return dev.type == "cuda" and not cfg.render.band_devices and not _eager


def recording_context() -> tuple:
    """What, besides a stage's configuration, decides the kernels that a
    capture records: the compositor, binning and binning-tail entry points
    in place (a comparison run swaps in their plain versions),
    deterministic algorithms and TF32 matrix products (the plain
    compositor's)."""
    from ..ops import binning, cuda_raster, render

    return (cuda_raster.packed_composite, binning.bin_tail, render.bin_gaussians,
            torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32)


def stage_key(cfg, capacity: int, dev: torch.device, weights) -> tuple:
    """The cache key of a stage: what its graphs depend on besides the
    data in its buffers."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (cfg, capacity, dev, weights, recording_context())


@contextlib.contextmanager
def sync_check(dev: torch.device, mode: str = "error"):
    """On a CUDA device, ``torch.cuda.set_sync_debug_mode(mode)`` inside the
    block: with "error" any synchronising CUDA call raises, with "default"
    it is allowed (a graph's warm-up inside a checked stage)."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CapturedGraph:
    """``fn(buffers)`` recorded as one CUDA graph on `dev` (see the module
    docstring). ``outputs`` is what fn returned under capture, rewritten by
    every ``replay()``; ``launches`` the kernel launches of one replay;
    ``capture_s`` and ``instantiate_s`` the seconds of the capture and of
    its instantiation. The captured graph is kept (``graph.raw_cuda_graph()``
    for a node count)."""

    def __init__(self, fn, buffers, dev: torch.device):
        self.dev = dev
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            # the warm-up may synchronise (a constant's first copy to the card)
            with torch.cuda.stream(side), _build.recording() as self.warmup_launches, \
                    sync_check(dev, "default"):
                scratch = buffers.scratch()
                for _ in range(WARMUP):
                    fn(scratch)
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with _build.recording() as self.launches, \
                    torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev)), \
                    sync_check(dev):
                self.outputs = fn(buffers)
            t1 = time.perf_counter()
            self.graph.instantiate()
            self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1

    def replay(self) -> None:
        with torch.cuda.device(self.dev):
            self.graph.replay()
        _build.replay_launches(self.launches)


class Eager:
    """The stage's pieces run as plain calls on `buffers` (the CPU, the
    tile-band mode, ``disable_graphs()``)."""

    def __init__(self, buffers):
        self.buffers = buffers

    def __call__(self, name: str, fn):
        return fn(self.buffers)


class StageGraphs:
    """One cache entry: the static `buffers` of one key and the graphs
    recorded on them. ``self(name, fn)`` replays graph `name`, recording
    fn(buffers) as it at its first use, and returns its outputs."""

    def __init__(self, buffers, dev: torch.device, capture=CapturedGraph):
        self.buffers, self.dev, self.capture = buffers, dev, capture
        self.graphs: dict = {}

    def __call__(self, name: str, fn):
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs[name] = self.capture(fn, self.buffers, self.dev)
        graph.replay()
        REPLAYS[name] += 1
        return graph.outputs


class GraphCache:
    """At most `maxsize` ``StageGraphs``, the least recently used leaving
    first (the counterpart of ``_compiled_stage``'s lru_cache). `capture`
    records one graph (``CapturedGraph``; a test passes a fake)."""

    def __init__(self, maxsize: int = MAX_ENTRIES, capture=CapturedGraph):
        self.maxsize, self.capture = maxsize, capture
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def entry(self, key, make_buffers, dev: torch.device) -> StageGraphs:
        """The entry of `key`, made with make_buffers() if missing."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        entry = self.entries[key] = StageGraphs(make_buffers(), dev, self.capture)
        if len(self.entries) > self.maxsize:
            self.entries.popitem(last=False)
        return entry


# the cache of stages run without a cache of their own (train_stage's graphs=None)
DEFAULT_CACHE = GraphCache()
