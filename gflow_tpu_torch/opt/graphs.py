"""CUDA graphs: the counterpart of the JAX package's compiled code.

``gflow_tpu/opt/train.py`` runs a stage as jitted ``lax.fori_loop``s split
at the static densify events (:536-551) and its snapshot path as a
``lax.scan`` over chunks (:555-588); ``gflow_tpu/pipeline/trainer.py:52-58``
keeps one compiled stage per ``StageConfig`` (an ``lru_cache(maxsize=32)``
over ``jax.jit``). Here, on a CUDA device, ``opt.train.train_stage`` runs
each piece of its loop body (an iteration, a rebinning, a snapshot) as the
replay of a CUDA graph recorded once per static configuration, and densify
runs eagerly between replays, as ``apply_densify`` runs between the
``fori_loop``s. The JAX package also compiles every device path that host
code calls (``render_jit``, ``render_traj_jit``, the trainer's
``_compiled_diag``, ``_compiled_traj_render``, ``_compiled_world2pix``,
``_compiled_gather_project``, ``_quantize_u8``), one compile per static
call shape in an lru cache; here each is a ``ForwardCache``: a pure
forward function of fixed-shape inputs, recorded once per key and
replayed. So is the prior preparation's compiled code: the prep models'
``jax.jit(model.apply)`` (``module_call``: GMFlow, MASt3R and their mesh
replicas, keyed on the model's parameter storage), the jitted LMedS
(``ops/epipolar.py``) and ``sharded_train_step``'s jitted B-frame step
(``parallel/multichip.py``, one capture over its mesh's cards); the
global alignment's jitted ``fori_loop`` is a ``GraphCache`` of chunks of
Adam steps on fixed buffers (``models/mast3r/alignment.py``).

- ``StageGraphs`` is one cache entry: the static buffers of one key and the
  graphs recorded on them, by name. A graph is recorded at its first use
  (``CapturedGraph``): its function runs ``WARMUP`` times on scratch copies
  of the buffers on a side stream, so that lazy initialisation happens
  outside the capture and the buffers stay as they were, then once under
  capture on the buffers themselves. A replay reads and writes the
  buffers in place; what the function returned is the graph's static
  output, rewritten by every replay.
- ``GraphCache`` holds at most ``maxsize`` entries, the least recently used
  leaving first. A stage's key (``stage_key``) is the configuration, the
  capacity, the device, the loss weights (numbers a capture bakes in) and
  ``recording_context()``. A forward function's key is its static
  arguments, the shapes and dtypes of its inputs (a capacity among them),
  the device and ``recording_context()``; per-call values (a camera, a
  point count) are data in its buffers, loaded before each replay (host
  tensors through pinned memory, so no call before a replay blocks the
  host). Its outputs are cloned before the next replay can rewrite them,
  and the graphs of one ``ForwardCache`` share one memory pool.
- A graph may span several cards (the tile-band mode: ``cfg.render``'s
  ``band_devices``): each other card's stream joins the capture through an
  event, the card's allocations go to a pool of their own for the graph's
  life, and autograd runs the backward on the capturing thread, on the
  streams the forward used, so that every band's K3 and copies are
  recorded too.
- Launch accounting: a capture logs its kernel launches instead of
  counting them (``_build.recording``), and every replay counts the log
  into ``_build.LAUNCHES``; the warm-up's launches, on scratch data, are
  kept apart (``CapturedGraph.warmup_launches``). ``REPLAYS`` counts the
  replays per graph name.
- ``disable_graphs()``, the counterpart of ``jax.disable_jit()``, runs
  stages and forward functions eagerly on the card, for comparison runs.
  Nothing falls back to it: a capture or a replay that fails raises.

A replay runs the eager call's kernels in its order, so under
deterministic algorithms it gives the eager call's numbers exactly.
Outside them the gather's transpose (``index_add_``) sums with float
atomics, and any two runs, replayed or eager, differ by rounding.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
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
    """Run stages and forward functions eagerly on the card inside the
    block: the counterpart of ``jax.disable_jit()``, for comparison runs."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


def graphed(dev: torch.device) -> bool:
    """Whether work on `dev` runs as CUDA graphs: on a CUDA device, outside
    ``disable_graphs()``."""
    return dev.type == "cuda" and not _eager


def recording_context() -> tuple:
    """What, besides a stage's configuration, decides the kernels that a
    capture records: the compositor, binning, binning-tail and SSIM entry
    points in place (a comparison run swaps in their plain versions),
    deterministic algorithms and TF32 matrix products (the plain
    compositor's)."""
    from ..ops import binning, cuda_raster, render
    from . import losses

    return (cuda_raster.packed_composite, binning.bin_tail, render.bin_gaussians, losses.ssim,
            torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32)


def _indexed(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stage_key(cfg, capacity: int, dev: torch.device, weights) -> tuple:
    """The cache key of a stage: what its graphs depend on besides the
    data in its buffers."""
    return (cfg, capacity, _indexed(dev), weights, recording_context())


def graph_key(static, dev: torch.device) -> tuple:
    """The cache key of graphs recorded on fixed buffers (the alignment's
    Adam steps): their static arguments and shapes, the device and
    ``recording_context()``."""
    return (static, _indexed(dev), recording_context())


def module_key(model: torch.nn.Module) -> tuple:
    """What a recorded forward of `model` depends on besides its inputs:
    its class and configuration; the storage of its parameters and buffers,
    which a graph reads in place (a model moved with ``.to`` or loaded into
    new tensors records anew, one loaded into its own tensors replays the
    same graph on the new values); its training flag, grad and inference
    mode."""
    state = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                  for t in itertools.chain(model.parameters(), model.buffers()))
    return (type(model), getattr(model, "config", None), state, model.training,
            torch.is_grad_enabled(), torch.is_inference_mode_enabled())


def tree_map(fn, tree):
    """fn applied to every tensor of a (nested) NamedTuple, tuple or dict;
    other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _staged(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """x ready for a copy to `dev` that does not block the host: a host
    tensor bound for a card goes through a pinned copy of its own (the
    caller may change x at once; the pinned block lives until the copy is
    done), so no synchronising call precedes a replay."""
    if x.device.type != "cpu" or dev.type != "cuda":
        return x
    staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return staged.copy_(x)


def copy_into(dst, src):
    """Copy every tensor of `src` into the tensor at the same place in
    `dst`, without blocking the host (``_staged``)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(_staged(src, dst.device), non_blocking=True)
    elif isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            copy_into(d, s)


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
    """``fn(buffers)`` recorded as one CUDA graph on `dev` and, where it
    reaches them, on the cards of `devices` (see the module docstring);
    `pool` is the memory pool of `dev` that the capture allocates from
    (None: a pool of its own). ``outputs`` is what fn returned under
    capture, rewritten by every ``replay()``; ``launches`` the kernel
    launches of one replay; ``capture_s`` and ``instantiate_s`` the seconds
    of the capture and of its instantiation. The captured graph is kept
    (``graph.raw_cuda_graph()`` for a node count)."""

    def __init__(self, fn, buffers, dev: torch.device, devices=(), pool=None):
        self.dev = dev = _indexed(dev)
        others = [d for d in dict.fromkeys(map(_indexed, devices)) if d != dev]
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
            # the other cards' allocations, kept for the graph's life
            self.pools = {}
            for d in others:
                with torch.cuda.device(d):
                    self.pools[d] = torch.cuda.MemPool()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            # capture_begin itself, not torch.cuda.graph: that one also
            # synchronises and empties the allocator's cache, which the
            # next eager calls would pay for
            with _build.recording() as self.launches, contextlib.ExitStack() as stack:
                stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
                self.graph.capture_begin(**({} if pool is None else {"pool": pool}),
                                         capture_error_mode="thread_local")
                stack.callback(self.graph.capture_end)
                home = torch.cuda.current_stream(dev)
                joined = []
                if others:
                    # a band's backward on the capturing thread, where its
                    # allocations go to the card's pool
                    stack.enter_context(torch.autograd.set_multithreading_enabled(False))
                for d in others:
                    s = torch.cuda.Stream(d)
                    s.wait_stream(home)  # the card's stream joins the capture
                    stack.enter_context(torch.cuda.stream(s))
                    stack.enter_context(torch.cuda.use_mem_pool(self.pools[d], d))
                    joined.append(s)
                # setting a card's stream made that card current: fn runs
                # with `dev` current, as it does eagerly
                stack.enter_context(torch.cuda.device(dev))
                with sync_check(dev):
                    self.outputs = fn(buffers)
                for s in joined:
                    home.wait_stream(s)
            t1 = time.perf_counter()
            self.graph.instantiate()
            self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1

    def replay(self) -> None:
        with torch.cuda.device(self.dev):
            self.graph.replay()
        _build.replay_launches(self.launches)


class Eager:
    """The stage's pieces run as plain calls on `buffers` (the CPU,
    ``disable_graphs()``)."""

    def __init__(self, buffers):
        self.buffers = buffers

    def __call__(self, name: str, fn):
        return fn(self.buffers)


class StageGraphs:
    """One cache entry: the static `buffers` of one key and the graphs
    recorded on them. ``self(name, fn)`` replays graph `name`, recording
    fn(buffers) as it at its first use with ``capture(fn, buffers, dev,
    devices, pool)``, and returns its outputs."""

    def __init__(self, buffers, dev: torch.device, capture=CapturedGraph, devices=(),
                 pool=None):
        self.buffers, self.dev, self.capture = buffers, dev, capture
        self.devices, self.pool = tuple(devices or ()), pool
        self.graphs: dict = {}

    def __call__(self, name: str, fn):
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs[name] = self.capture(fn, self.buffers, self.dev, self.devices,
                                                     self.pool)
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

    def pool(self, dev: torch.device):
        """The memory pool of `dev` that this cache's captures share (None:
        each graph keeps a pool of its own)."""
        return None

    def entry(self, key, make_buffers, dev: torch.device, devices=()) -> StageGraphs:
        """The entry of `key`, made with make_buffers() if missing; its
        graphs span `dev` and the cards of `devices`."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        entry = self.entries[key] = StageGraphs(make_buffers(), dev, self.capture, devices,
                                                self.pool(dev))
        if len(self.entries) > self.maxsize:
            self.entries.popitem(last=False)
        return entry


class ForwardBuffers:
    """The static inputs of a forward graph: copies on the card of one
    call's input tensors, into which each call's inputs are loaded (host
    tensors through pinned memory, without blocking the host)."""

    def __init__(self, inputs: dict, dev: torch.device):
        self.inputs = tree_map(
            lambda x: _staged(x, dev).to(dev, copy=True, non_blocking=True), inputs)

    def load(self, inputs: dict) -> None:
        copy_into(self.inputs, inputs)

    def scratch(self) -> "ForwardBuffers":
        return self  # a forward function reads its inputs only


class ForwardCache(GraphCache):
    """``self(key, fn, inputs, dev)`` is fn(**inputs) on `dev`: on a CUDA
    device the replay of graph `name`, recorded once per `key` (fn's
    static arguments) and input shapes; eagerly on the CPU and inside
    ``disable_graphs()``. `inputs` is a dict of tensors (or tuples of
    them) on any device; a call loads them into the entry's buffers
    (device-to-device copies, or one host-to-device copy each, outside the
    capture and the replay) and returns fn's outputs cloned, so that the
    next replay leaves them as they are. The graphs share one memory pool
    per device: their inputs live outside it and their outputs are cloned
    before another graph of the cache replays."""

    def __init__(self, name: str, maxsize: int, capture=CapturedGraph):
        super().__init__(maxsize, capture)
        self.name = name
        self.pools: dict = {}

    def pool(self, dev: torch.device):
        """The graph memory pool of `dev` that the cache's graphs share. A
        pool lives while a graph recorded into it does, so the cache keeps
        one of its own there, a single fill, for as long as it lives: a
        graph recorded after an eviction allocates from the same pool."""
        dev = _indexed(dev)
        if dev.type != "cuda":
            return None
        if dev not in self.pools:
            keeper = torch.cuda.CUDAGraph()
            with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
                keeper.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                     capture_error_mode="thread_local")
                torch.zeros(1, device=dev)
                keeper.capture_end()
            self.pools[dev] = keeper
        return self.pools[dev].pool()

    def __call__(self, key, fn, inputs: dict, dev: torch.device, devices=()):
        if not graphed(dev):
            return fn(**tree_map(lambda x: x.to(dev), inputs))
        shapes = tuple(tree_map(lambda x: (tuple(x.shape), x.dtype), v)
                       for v in inputs.values())
        key = (key, tuple(inputs), shapes, _indexed(dev), recording_context())
        entry = self.entry(key, lambda: ForwardBuffers(inputs, dev), dev, devices)
        entry.buffers.load(inputs)
        with sync_check(dev):
            out = entry(self.name, lambda b: fn(**b.inputs))
            return tree_map(torch.clone, out)


def module_call(cache: ForwardCache, model: torch.nn.Module, *inputs, device=None):
    """model(*inputs) on `device` (default: the first input's) through
    `cache`: on a CUDA device the replay of a graph recorded once per
    ``module_key(model)`` and input shapes, the inputs copied into its
    buffers and its outputs cloned; eagerly on the CPU and inside
    ``disable_graphs()``."""
    dev = inputs[0].device if device is None else torch.device(device)
    return cache(module_key(model), lambda **kw: model(*kw.values()),
                 {f"x{i}": x for i, x in enumerate(inputs)}, dev)


# the cache of stages run without a cache of their own (train_stage's graphs=None)
DEFAULT_CACHE = GraphCache()
