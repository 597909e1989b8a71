"""Time two builds of the compositor kernels (K1, K2, K3) on the same card,
in one process, in turns: baseline, change, change, baseline.

    python3 scripts/torch_compositor_ab.py --baseline _parent

`--baseline` is the root of another checkout of the repo (for instance the
parent commit unpacked with `git archive` into a git-ignored directory);
its `gflow_tpu_torch/csrc/composite.cu` is built with the same nvcc flags
as this checkout's. Both libraries are called through the same C entry
points on the same inputs: chip_smoke.py's synthetic packed inputs, the
same with every tile at the mean count ("synthetic even"), and the main
path's own packed input (first iteration of each stage of the canonical
frame; the full stage's also at its mean count), at K = 96 and 192. For each kernel and input the script
checks that the two builds agree (images atol 5e-4 / rtol 1e-3, K3 to 5e-4
normalized by max |ref| per column), prints one JSON line per row with the
four device times (ms, CUDA-graph replay as in chip_smoke.py) and the
card's name and power limit, and writes all rows to
chiprun_out/compositor_ab.json.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from torch_ab import ROOT, TURNS, build, c_function, card, write_rows

import chip_smoke as cs  # noqa: E402  (torch_ab put the root on sys.path)
from gflow_tpu_torch.ops import _build  # noqa: E402
from gflow_tpu_torch.ops.composite import P_PIX  # noqa: E402


def bind(lib):
    return {name: c_function(lib, *_build.KERNELS[name][1:])
            for name in ("composite_fwd", "composite_fwd_cov", "composite_bwd")}


def compare(libs, attrs, counts, bg, n_tx, with_cov, g, where, K):
    """Rows for the forward (K1 or K2) and K3 on one input."""
    T, _, CA = attrs.shape
    F = CA - 6 - int(with_cov)
    dev = attrs.device
    fwd_name = "composite_fwd_cov" if with_cov else "composite_fwd"
    outs = {tag: (torch.empty((T, P_PIX, F), device=dev),
                  torch.empty((T, P_PIX, 1), device=dev),
                  torch.empty_like(attrs)) for tag in libs}

    def fwd(tag):
        out, cov, _ = outs[tag]
        args = [counts, attrs, bg, out] + ([cov] if with_cov else []) + [T, K, CA, F, n_tx]
        libs[tag][fwd_name](*args)

    def bwd(tag):
        libs[tag]["composite_bwd"](counts, attrs, bg, g, outs[tag][2], T, K, CA, F, n_tx)

    rows = []
    for name, fn in ((fwd_name, fwd), ("composite_bwd", bwd)):
        for tag in libs:
            fn(tag)
        torch.cuda.synchronize()
        if name == "composite_bwd":
            a, b = outs["baseline"][2], outs["change"][2]
            scale = a.abs().amax(dim=(0, 1)).clamp_min(1e-12)
            diff = float(((a - b) / scale).abs().max())
            assert diff <= 5e-4, (name, where, K, diff)
        else:
            torch.testing.assert_close(outs["baseline"][0], outs["change"][0],
                                       atol=5e-4, rtol=1e-3)
            if with_cov:
                torch.testing.assert_close(outs["baseline"][1], outs["change"][1],
                                           atol=5e-4, rtol=1e-3)
            diff = float((outs["baseline"][0] - outs["change"][0]).abs().max())
        times = {}
        for tag in TURNS:
            times.setdefault(tag, []).append(cs.kernel_ms(lambda: fn(tag)))
        rows.append(dict(kernel=name, input=where, K=K, live_slots=float(counts.sum()),
                         baseline_ms=times["baseline"], change_ms=times["change"],
                         max_diff=diff))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout whose composite.cu is the baseline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_compositor_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = {"baseline": bind(build(args.baseline, "composite.cu", "baseline")),
            "change": bind(build(ROOT, "composite.cu", "change"))}
    print(f"# two nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    n_tx, n_ty = -(-cs.W // 16), -(-cs.H // 16)
    T, F = n_tx * n_ty, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    bg = torch.zeros(F, device="cuda")
    main_inputs = cs.main_path_inputs(cs.bench_scene())
    rows = []
    for K in (96, 192):
        for with_cov in (False, True):
            attrs, counts = cs.packed_inputs(gen, T, K, F, with_cov, n_tx)
            g = torch.randn((T, P_PIX, F), generator=gen, device="cuda")
            rows += compare(libs, attrs, counts, bg, n_tx, with_cov, g, "synthetic", K)
            # the same rows with every tile at the mean count: the time that
            # uneven per-tile work adds
            even = torch.full_like(counts, round(float(counts.float().mean())))
            rows += compare(libs, attrs, even, bg, n_tx, with_cov, g, "synthetic even", K)
        for stage, rec in main_inputs[K].items():
            rows += compare(libs, rec["attrs"], rec["counts"], rec["bg"], rec["n_tx"],
                            rec["with_cov"], rec["g"], f"main {stage}", K)
        rec = main_inputs[K]["full"]
        even = torch.full_like(rec["counts"], round(float(rec["counts"].float().mean())))
        rows += compare(libs, rec["attrs"], even, rec["bg"], rec["n_tx"], False, rec["g"],
                        "main full even", K)
    write_rows("compositor_ab", smi, rows)


if __name__ == "__main__":
    main()
