"""Time two builds of the binning tail (K4, csrc/pack.cu) on the same card,
in one process, in turns: baseline, change, change, baseline.

    python3 scripts/torch_binning_ab.py --baseline _parent

`--baseline` is the root of another checkout of the repo (for instance the
parent commit unpacked with `git archive` into a git-ignored directory);
its `gflow_tpu_torch/csrc/pack.cu` is built with the same nvcc flags as
this checkout's. A build's tail is what its C entry point defines:

- `gflow_bin_tail`: one launch from the sorted stream;
- `gflow_pack_tile_lists` (the first design): the L-wide gather
  idx_flat[order], the shift, the probe arange, torch.searchsorted and the
  counts in PyTorch, then that pack kernel, on the ids materialized by
  `binning.entry_ids` (as the first design built them before its sort).
  The tail rows time it from the materialized ids, i.e. its six launches
  after the sort; the binning layer rows include the materialization.

Inputs: chip_smoke.py's synthetic stream, the main path's own sorted stream
of each stage's first iteration, and the two-class stream of the full
stage's projection, at K = 96 and 192. Both builds' lists and counts must
equal `binning.bin_tail_plain`'s. Per stream and K: each build's whole tail
and its kernel alone (device time, CUDA-graph replay as chip_smoke.py's
kernel_ms), the host time of one tail call, torch.searchsorted alone and
the bound (chip_smoke.tail_bytes); this checkout's `binning.bin_tail`'s
host time; and, for a single-class stream, what its group size saves: the
device and host time of materializing its ids, and this checkout's tail on
the materialized ids. Per stage: the binning layer, bin_gaussians with its
tail from each build, as device kernels and device ms per call
(torch.profiler) and as the time of one call between CUDA events, host
launches included. Prints one JSON line per row with the card's name and
power limit and writes all rows to chiprun_out/binning_ab.json.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from torch_ab import ROOT, TURNS, build, c_function, card, write_rows

import chip_smoke as cs  # noqa: E402  (torch_ab put the root on sys.path)
from gflow_tpu_torch.ops import _build, binning  # noqa: E402


def host_us(fn, reps=50) -> float:
    """Median host time of one fn() in us: perf_counter around the call,
    launches included, the device idle before it and not waited for."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def first_design_front(key_s, order, ids, nbits, T):
    """The first design's tail up to its pack kernel, from materialized ids:
    the L-wide gather, the shift, the probe arange, searchsorted and the
    counts (the slice starts[:T] is contiguous: no copy). Returns what that
    pack kernel took: (ids in sorted order, starts, counts)."""
    idx_s = ids[order].contiguous()
    starts = torch.searchsorted(key_s >> nbits,
                                torch.arange(T + 1, dtype=torch.int32, device=key_s.device),
                                side="left", out_int32=True)
    return idx_s, starts[:T].contiguous(), starts[1:] - starts[:T]


def bind(lib):
    """(tail, kernels) of one build: tail(key_s, order, idx_flat, nbits, T,
    K) -> (lists, counts), and kernels(same) -> {kernel name: zero-argument
    launch of the build's kernel alone on preallocated buffers}."""
    def outputs(T, K):
        return (torch.empty(T, dtype=torch.int32, device="cuda"),
                torch.empty((T, K), dtype=torch.int32, device="cuda"))

    if hasattr(lib, "gflow_bin_tail"):
        tail_k = c_function(lib, "gflow_bin_tail", _build.KERNELS["bin_tail"][2])

        def launch(key_s, order, idx_flat, nbits, T, K, counts, lists):
            tail_k(key_s, order, *binning.kernel_ids(idx_flat), counts, lists, key_s.shape[0],
                   T, K, nbits)

        def tail(key_s, order, idx_flat, nbits, T, K):
            counts, lists = outputs(T, K)
            launch(key_s, order, idx_flat, nbits, T, K, counts, lists)
            return lists, counts

        def kernels(key_s, order, idx_flat, nbits, T, K):
            counts, lists = outputs(T, K)
            return {"bin_tail": lambda: launch(key_s, order, idx_flat, nbits, T, K, counts,
                                               lists)}
        return tail, kernels

    _P, _I = ctypes.c_void_p, ctypes.c_int
    pack_k = c_function(lib, "gflow_pack_tile_lists", (_P, _P, _P, _P, _I, _I))

    def front(key_s, order, idx_flat, nbits, T):
        ids = binning.entry_ids(idx_flat, key_s.shape[0], key_s.device)
        return first_design_front(key_s, order, ids, nbits, T)

    def tail(key_s, order, idx_flat, nbits, T, K):
        idx_s, starts, counts = front(key_s, order, idx_flat, nbits, T)
        lists = outputs(T, K)[1]
        pack_k(idx_s, starts, counts, lists, T, K)
        return lists, counts

    def kernels(key_s, order, idx_flat, nbits, T, K):
        idx_s, starts, counts = front(key_s, order, idx_flat, nbits, T)
        lists = outputs(T, K)[1]
        return {"pack_tile_lists": lambda: pack_k(idx_s, starts, counts, lists, T, K)}
    return tail, kernels


def compare_tails(builds, stream, K, where):
    key_s, order, idx_flat, nbits, T = stream
    L = key_s.shape[0]
    want = binning.bin_tail_plain(key_s, order, idx_flat, nbits, T, K)
    for tag, (tail, _) in builds.items():
        for g_, w_ in zip(tail(key_s, order, idx_flat, nbits, T, K), want):
            assert torch.equal(g_, w_), (tag, where, K)
    kernels = {tag: k(key_s, order, idx_flat, nbits, T, K) for tag, (_, k) in builds.items()}
    # the first design's tail from materialized ids: its launches after the sort
    ids = binning.entry_ids(idx_flat, L, key_s.device)
    args = {tag: (key_s, order, ids if "pack_tile_lists" in kernels[tag] else idx_flat, nbits,
                  T, K) for tag in builds}
    times = {}
    for tag in TURNS:
        tail = builds[tag][0]
        times.setdefault(f"{tag}_tail_ms", []).append(cs.kernel_ms(lambda: tail(*args[tag])))
        times.setdefault(f"{tag}_tail_host_us", []).append(host_us(lambda: tail(*args[tag])))
        for name, fn in kernels[tag].items():
            times.setdefault(f"{tag}_{name}_ms", []).append(cs.kernel_ms(fn))
    tile_s = key_s >> nbits
    probe = torch.arange(T + 1, dtype=torch.int32, device="cuda")
    live = float(want[1].clamp_max(K).sum())
    row = dict(row="tail", input=where, K=K, entries=L, live_slots=live,
               bound_ms=cs.bound(0.0, cs.tail_bytes(stream, K, live))[0],
               searchsorted_ms=cs.kernel_ms(
                   lambda: torch.searchsorted(tile_s, probe, out_int32=True)),
               bin_tail_host_us=host_us(
                   lambda: binning.bin_tail(key_s, order, idx_flat, nbits, T, K)),
               **times)
    if ids is not idx_flat:  # a group size: what not materializing the ids saves
        change = builds["change"][0]
        row.update(entry_ids_ms=cs.kernel_ms(lambda: binning.entry_ids(idx_flat, L, "cuda")),
                   entry_ids_host_us=host_us(lambda: binning.entry_ids(idx_flat, L, "cuda")),
                   change_tail_on_ids_ms=cs.kernel_ms(
                       lambda: change(key_s, order, ids, nbits, T, K)))
    return row


def device_profile(fn, n=20):
    """Device kernels and device ms per call of fn(), from torch.profiler
    over n calls after one warm-up call (device rows only, since an
    operator's row repeats its kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return {"kernels_per_call": "not measured", "device_ms_per_call": "not measured"}
    return {"kernels_per_call": sum(r[1] for r in rows) / n,
            "device_ms_per_call": sum(r[0] for r in rows) / 1e3 / n,
            "kernels": [{"name": k[:90], "calls": c / n, "ms": us / 1e3 / n}
                        for us, c, k in sorted(rows, reverse=True)]}


def compare_layer(builds, bin_call, stage):
    args, kw = bin_call
    row = dict(row="binning layer", input=f"main {stage}", K=kw["max_per_tile"])
    for tag in TURNS:
        with mock.patch.object(binning, "bin_tail", builds[tag][0]):
            prof = device_profile(lambda: binning.bin_gaussians(*args, **kw))
            call_ms = cs.cuda_ms(lambda: binning.bin_gaussians(*args, **kw))
        for k in ("kernels_per_call", "device_ms_per_call"):
            row.setdefault(f"{tag}_{k}", []).append(prof[k])
        row.setdefault(f"{tag}_call_ms", []).append(call_ms)
        row[f"{tag}_kernels"] = prof.get("kernels")
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout whose pack.cu is the baseline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_binning_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = {"baseline": bind(build(args.baseline, "pack.cu", "baseline")),
              "change": bind(build(ROOT, "pack.cu", "change"))}
    print(f"# two nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    T = -(-cs.W // 16) * -(-cs.H // 16)
    main_inputs = cs.main_path_inputs(cs.bench_scene())[96]
    streams = {"synthetic": cs.synthetic_stream(torch.Generator(device="cuda").manual_seed(1), T),
               **{f"main {stage}": rec["stream"] for stage, rec in main_inputs.items()},
               "two-class": cs.two_class_stream(main_inputs["full"]["bin_call"])}
    rows = [compare_tails(builds, stream, K, where)
            for K in (96, 192) for where, stream in streams.items()]
    rows += [compare_layer(builds, rec["bin_call"], stage) for stage, rec in main_inputs.items()]
    write_rows("binning_ab", smi, rows)


if __name__ == "__main__":
    main()
