"""What the A/B scripts (scripts/torch_compositor_ab.py,
scripts/torch_binning_ab.py, scripts/torch_small_eig_ab.py) share: one
source of `gflow_tpu_torch/csrc`, from this checkout or another, built with
this checkout's nvcc flags and bound through its C entry points; the
order of the turns; the card's name and power limit; the rows written to
chiprun_out/<name>.json.

Importing it puts the repo's root on sys.path, so that a script can then
import chip_smoke and gflow_tpu_torch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gflow_tpu_torch.ops import _build  # noqa: E402

TURNS = ("baseline", "change", "change", "baseline")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build(checkout: Path, source: str, tag: str, extra=()) -> ctypes.CDLL:
    """`gflow_tpu_torch/csrc/<source>` of `checkout`, compiled (with the
    nvcc flags `extra` added) and loaded; the compiler's output goes to
    `_build.BUILD_LOGS["<stem>-<tag>"]`."""
    src = checkout / "gflow_tpu_torch" / "csrc" / source
    out = _build.BUILD_DIR / "ab" / f"{Path(source).stem}-{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    _build.BUILD_LOGS[f"{Path(source).stem}-{tag}"] = proc.stdout + proc.stderr
    return ctypes.CDLL(str(out))


def c_function(lib, symbol, argtypes):
    """A launch through C entry point `symbol` on the current stream:
    tensors go as device pointers, ints as C ints; raises on a CUDA error."""
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = (*argtypes, ctypes.c_void_p), ctypes.c_int

    def call(*args):
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
        rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} failed to launch: cudaError {rc}")
    return call


def write_rows(name: str, smi: str, rows: list) -> None:
    """One JSON line per row with the card, and all rows to
    chiprun_out/<name>.json."""
    for r in rows:
        print(json.dumps({**r, "card": smi}), flush=True)
    out = ROOT / "chiprun_out" / f"{name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
