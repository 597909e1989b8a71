"""Build and bind the hand-written CUDA kernels (``gflow_tpu_torch/csrc``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, on first use, and loaded with
``ctypes``. Libraries land in ``gflow_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. ``build_all`` starts one ``nvcc`` per
source, all together.

Every C entry point takes its tensors as raw device pointers (an optional
one may be 0, a null pointer), ints as C ints and floats as C floats,
plus the current CUDA stream of their device, launches, and returns
``cudaGetLastError()``; ``launch`` raises when that is nonzero and counts
the launch in ``LAUNCHES``. A launch made while a CUDA graph is recorded runs only when
the graph is replayed: inside ``recording()`` it goes to the recording's
log instead, and ``replay_launches`` counts the log at every replay.
``-Xptxas -v`` makes each build report its kernels'
registers, shared memory and spills (``BUILD_LOGS``). No
``--use_fast_math``: ``expf`` must stay accurate, because alpha is
compared against the 1/255 threshold.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (source file, C symbol, argument types before the stream)
KERNELS = {
    "composite_fwd": ("composite.cu", "gflow_composite_fwd",
                      (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I)),
    "composite_fwd_cov": ("composite.cu", "gflow_composite_fwd_cov",
                          (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)),
    "composite_bwd": ("composite.cu", "gflow_composite_bwd",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)),
    "bin_tail": ("pack.cu", "gflow_bin_tail", (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I)),
    "small_eig": ("small_eig.cu", "gflow_small_eig", (_P, _P, _I, _I)),
    "stamp": ("stamp.cu", "gflow_stamp", (_P, _P, _I, _I, _I)),
    "ssim_fwd": ("ssim.cu", "gflow_ssim_fwd", (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P)),
    "ssim_bwd": ("ssim.cu", "gflow_ssim_bwd", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "sam_stream_init": ("sam_decoder.cu", "gflow_sam_stream_init",
                        (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P)),
    "sam_t2i_attend": ("sam_decoder.cu", "gflow_sam_t2i_attend",
                       (_P, _P, _P, _I, _I, _I, _P, _P, _P)),
    "sam_i2t_attend": ("sam_decoder.cu", "gflow_sam_i2t_attend", (_P, _P, _P, _I, _I, _I, _P)),
    "sam_residual_ln": ("sam_decoder.cu", "gflow_sam_residual_ln",
                        (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P)),
}

# launches per kernel name since the last reset (``LAUNCHES.clear()``):
# eager calls and CUDA graph replays
LAUNCHES: collections.Counter = collections.Counter()
# the part of LAUNCHES that CUDA graph replays made (replay_launches)
REPLAYED: collections.Counter = collections.Counter()
# callbacks f(name, args) at every launch that LAUNCHES counts, args being
# the launch's arguments with each tensor given as its shape
LAUNCH_HOOKS: list = []
# compiler output per source built by this process
BUILD_LOGS: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict = {}
_log: list | None = None  # the open recording's launch log (recording())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=None) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together. Returns {source: library path}. Raises with the
    compiler's output if any build fails."""
    sources = sorted({s for s, _, _ in KERNELS.values()} if sources is None
                     else set(sources))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    procs = {}
    for s, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[s] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {s} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[s])  # atomic: readers never see a partial .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/`source`, built on first use."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build_all([source])[source]))
    return _libs[source]


def _function(name: str):
    if name not in _fns:
        source, symbol, argtypes = KERNELS[name]
        fn = getattr(library(source), symbol)
        fn.argtypes = (*argtypes, _P)
        fn.restype = _I
        _fns[name] = fn
    return _fns[name]


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current CUDA stream of the device its
    tensor arguments live on (which need not be the current device). Tensor
    arguments go as device pointers, ints as C ints, floats as C floats; the
    caller has checked shapes, dtypes and contiguity. Raises if the tensors
    span devices or on a nonzero CUDA error code."""
    dev = tensor_device(args)
    fn = _function(name)
    cargs = [_c_arg(a) for a in args]
    with torch.cuda.device(dev):
        rc = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch on {dev}: cudaError {rc}")
    count_launch(name, tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else c
                             for a, c in zip(args, cargs)))


def _c_arg(a):
    """A launch argument as ctypes takes it: a tensor's device pointer, a
    float as it is (a C float), anything else as an int."""
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    return a if isinstance(a, float) else int(a)


def count_launch(name: str, args: tuple) -> None:
    """Count one launch of kernel `name` in LAUNCHES and tell the hooks,
    or, inside ``recording()``, log it there instead."""
    if _log is not None:
        _log.append((name, args))
        return
    LAUNCHES[name] += 1
    for hook in LAUNCH_HOOKS:
        hook(name, args)


@contextlib.contextmanager
def recording():
    """Log the launches made inside the block instead of counting them
    (they are recorded into a CUDA graph, or run on scratch data while one
    is warmed up); yields the log, a list of (name, args)."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        _log = outer


def replay_launches(log) -> None:
    """Count the launches of a recording's log: one replay of its graph."""
    for name, args in log:
        count_launch(name, args)
        REPLAYED[name] += 1


def tensor_device(args) -> torch.device:
    """The one CUDA device of the tensors among `args`; raises if there is
    none, if they span devices or if one lies off the card."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"a kernel's tensors must lie on one device, got {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type != "cuda":
        raise ValueError(f"a kernel's tensors must lie on a CUDA device, got {dev}")
    return dev
