"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``gflow_tpu_torch/csrc`` (one nvcc per
   source, in parallel), prints the build time, ptxas's registers and
   spills per compositor kernel and their resident blocks per SM;
3. holds each kernel against its plain PyTorch version on the card at the
   canonical shapes (T = 54 x 30 = 1620 tiles of the 854x480 frame,
   K in {96, 192}, F = 4), and times kernel, plain version and bound with
   CUDA events: on synthetic packed inputs and sorted streams, and on the
   main path's own packed input, upstream gradient and sorted stream (the
   first iteration of the canonical frame's camera-only and full stage);
   K4 (the binning tail, one launch) also on one two-class binning of
   the full stage's projection, and beside torch.searchsorted;
4. drives the port's main path — the per-frame fit of bench.py's scene
   (854x480, 50,000 points, capacity 51,200, seed 0, M=8 / K=96) — with
   the launch counters reset just before and read just after: a short
   camera-only stage, a full stage with an occluded-region densify and one
   error densify, and the next frame's camera-only stage; checks the loss
   falls, n_alive grows by the expected count, every kernel launched, and
   the first iteration's gradients of every parameter leaf (both stages),
   the loss trajectory and a multi-output render match the same run on
   the plain PyTorch versions (also on the card);
5. times one frame at the canonical budget (150 camera + 300 full
   iterations, occ densify at 0 and error densify every 100 x2) after one
   warm-up frame; profiles a 20-iteration full stage and, alone, the
   binning layer (bin_gaussians) on each stage's first-iteration input;
6. prints the kernels JSON line, then as its last line
   {"ok": true, "device": {...}}.

Any failure raises and exits nonzero. Without CUDA it exits 1 and prints
no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

# fp32 throughout, as the reference (Precision.HIGHEST); the plain
# compositor's einsum must not drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# cuBLAS needs a fixed workspace for the deterministic checks (deterministic())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

PEAK_FP32_FLOPS = 67e12    # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
W, H = 854, 480
N_POINTS, CAPACITY = 50_000, 51_200
# fp32 operations per (pixel, live slot) that the function needs, counted
# from csrc/composite.cu: alpha 17 (dx dy 2, power 9, min+exp+mul+clamp 4,
# masks 2); K1 adds w 1 + feat 2F + T 2, K2 adds mul+max 2. K3 evaluates
# alpha 17, fg 2F, w 1 and T 2 once (its second pass repeats them: that is
# the design's cost, not the function's), plus the suffix sum S_k 2 (w fg,
# add), dalpha 5, dpower 1, moments 5, dfeat F, one add per reduced value 6+F
OPS_K1 = lambda F: 20 + 2 * F
OPS_K2 = lambda F: 22 + 2 * F
OPS_K3 = lambda F: 39 + 4 * F


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3) -> float:
    """Median time of fn() in ms, CUDA events around each call (includes
    the host's launch time where the device waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(fn, n=20, reps=5) -> float:
    """Device time of one fn() in ms: n calls captured in a CUDA graph and
    replayed between CUDA events, so host launch time drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, reps=reps, warmup=1) / n


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def packed_inputs(gen, T, K, F, with_cov, n_tx):
    """Well-formed packed compositor input: per tile, up to 1.3 K depth-sorted
    rows around the tile, PSD conics of 0.7-6 px sigma, opacity 0.05-0.99."""
    dev = "cuda"
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    t = torch.arange(T, device=dev)
    origin = torch.stack([(t % n_tx) * 16.0, (t // n_tx) * 16.0], -1)
    uv = origin[:, None, :] + u(T, K, 2) * 32.0 - 8.0
    s1, s2 = 0.7 + 5.3 * u(T, K), 0.7 + 5.3 * u(T, K)
    th = u(T, K) * math.pi
    c, s = torch.cos(th), torch.sin(th)
    cxx = c * c * s1 * s1 + s * s * s2 * s2 + 0.3
    cxy = c * s * (s1 * s1 - s2 * s2)
    cyy = s * s * s1 * s1 + c * c * s2 * s2 + 0.3
    det = cxx * cyy - cxy * cxy
    conic = torch.stack([cyy / det, -cxy / det, cxx / det], -1)
    op = 0.05 + 0.94 * u(T, K, 1)
    feat = torch.cat([u(T, K, 3), 2.0 + 4.0 * u(T, K, 1)], -1)[..., :F]
    cols = [uv, conic, op, feat]
    if with_cov:
        cols.append((u(T, K, 1) < 0.4).float())
    attrs = torch.cat(cols, -1).contiguous()
    counts = torch.randint(0, int(1.3 * K) + 1, (T,), generator=gen, device=dev)
    counts[torch.randperm(T, generator=gen, device=dev)[: T // 10]] = 0  # empty tiles
    return attrs, counts.clamp_max(K).to(torch.int32).contiguous()


def fwd_row(attrs, counts, bg, n_tx, with_cov):
    """K1 (with_cov False) or K2 against its plain version on one packed
    input: error, kernel / plain / bound times."""
    from gflow_tpu_torch.ops import composite, cuda_raster

    T, K, CA = attrs.shape
    F = CA - 6 - int(with_cov)
    live = float(counts.sum())
    got = cuda_raster.composite_fwd(attrs, counts, bg, n_tx, with_cov)
    want = composite.composite_packed(attrs, counts, bg, n_tx, with_cov)
    got, want = (got, want) if with_cov else ((got,), (want,))
    torch.cuda.synchronize()
    err = 0.0
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=5e-4, rtol=1e-3)
        err = max(err, float((g_ - w_).abs().max()))
    if with_cov:  # coverage support must agree exactly where it is clear
        clear = (want[1] - 0).abs() > 1e-3
        assert torch.equal((got[1] > 0)[clear], (want[1] > 0)[clear])
    ms = kernel_ms(lambda: cuda_raster.composite_fwd(attrs, counts, bg, n_tx, with_cov))
    plain_ms = cuda_ms(lambda: composite.composite_packed(attrs, counts, bg, n_tx, with_cov),
                       reps=5)
    ops = live * 256 * (OPS_K2(F) if with_cov else OPS_K1(F))
    nbytes = 4 * (live * CA + T + F + T * 256 * (F + int(with_cov)))
    b_ms, b_by = bound(ops, nbytes)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                live_slots=live)


def bwd_row(attrs, counts, bg, g, n_tx, with_cov):
    """K3 against autograd through the plain version on one packed input
    and upstream gradient; also checks that two launches agree bitwise."""
    from gflow_tpu_torch.ops import composite, cuda_raster

    T, K, CA = attrs.shape
    F = CA - 6 - int(with_cov)
    live = float(counts.sum())
    got = cuda_raster.composite_bwd(attrs, counts, bg, g, n_tx, with_cov)

    def plain_bwd():
        a = attrs.detach().requires_grad_()
        out = composite.composite_packed(a, counts, bg, n_tx, with_cov)
        return torch.autograd.grad(out[0] if with_cov else out, a, g)[0]

    want = plain_bwd()
    assert torch.equal(got, cuda_raster.composite_bwd(attrs, counts, bg, g, n_tx, with_cov)), \
        "K3 is not bitwise repeatable"
    if with_cov:
        assert not got[..., -1].any(), "K3 gave the mov column a gradient"
    scale = want.abs().amax(dim=(0, 1)).clamp_min(1e-12)  # per column
    err = float((got - want).abs().max())
    norm_err = float(((got - want) / scale).abs().max())
    assert norm_err <= 5e-4, f"K3 normalized error {norm_err} > 5e-4"
    ms = kernel_ms(lambda: cuda_raster.composite_bwd(attrs, counts, bg, g, n_tx, with_cov))
    plain_ms = cuda_ms(plain_bwd, reps=5)
    b_ms, b_by = bound(live * 256 * OPS_K3(F),
                       4 * (live * CA + T + F + T * 256 * F + T * K * CA))
    return dict(max_abs_err=err, max_norm_err=norm_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, live_slots=live)


def synthetic_stream(gen, T):
    """A sorted stream of the main path's size: L = capacity x 8 entries
    (M = 8, single-class ids: group 8), tiles uniform in [0, T] (T = the
    sentinel), random depth bits."""
    L, nbits = CAPACITY * 8, 31 - (T + 1).bit_length()
    rand = lambda hi: torch.randint(0, hi, (L,), generator=gen, device=gen.device,
                                    dtype=torch.int32)
    key_s, order = torch.sort((rand(T + 1) << nbits) | rand(2 ** nbits))
    return key_s, order, 8, nbits, T


def search_sectors(tile_s, T):
    """32-byte sectors of the sorted tiles (int32, 8 per sector) that a
    binary search for the T + 1 segment starts reads (lower bound, as
    searchsorted side="left"), each counted once: the key bytes the starts
    need, not a full read of the keys."""
    L, dev = tile_s.shape[0], tile_s.device
    probe = torch.arange(T + 1, device=dev)
    lo = torch.zeros(T + 1, dtype=torch.long, device=dev)
    hi = torch.full((T + 1,), L, dtype=torch.long, device=dev)
    read = []
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) // 2
        read.append(mid[live])
        less = tile_s[mid.clamp_max(L - 1)] < probe
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    return int(torch.unique(torch.cat(read) // 8).numel()) if read else 0


def tail_bytes(stream, K, live):
    """Bytes the binning tail must move: the key sectors a search for the
    segment starts reads, each live slot's order entry and id
    (binning.slot_bytes), the lists and counts written once."""
    from gflow_tpu_torch.ops import binning

    key_s, _, idx_flat, nbits, T = stream
    return (32 * search_sectors(key_s >> nbits, T) + binning.slot_bytes(idx_flat) * live
            + 4 * T * K + 4 * T)


def tail_row(stream, K, where):
    """K4 on one sorted stream: bin_tail against bin_tail_plain
    (torch.equal), timed beside its plain version, its bound and
    torch.searchsorted, which computes the segment starts alone (no one
    PyTorch call computes the whole tail, so library_ms is None)."""
    from gflow_tpu_torch.ops import binning

    key_s, order, idx_flat, nbits, T = stream
    got = binning.bin_tail(key_s, order, idx_flat, nbits, T, K)
    want = binning.bin_tail_plain(key_s, order, idx_flat, nbits, T, K)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_), f"bin_tail differs from its plain version ({where}, K={K})"
    live = float(got[1].clamp_max(K).sum())
    tile_s = key_s >> nbits
    probe = torch.arange(T + 1, dtype=torch.int32, device=key_s.device)
    b_ms, b_by = bound(0.0, tail_bytes(stream, K, live))
    return dict(
        max_abs_err=0.0,
        ms=kernel_ms(lambda: binning.bin_tail(key_s, order, idx_flat, nbits, T, K)),
        plain_ms=cuda_ms(lambda: binning.bin_tail_plain(key_s, order, idx_flat, nbits, T, K)),
        library_ms=None,
        searchsorted_ms=kernel_ms(lambda: torch.searchsorted(tile_s, probe, out_int32=True)),
        bound_ms=b_ms, bound_by=b_by, live_slots=live, entries=key_s.shape[0])


def two_class_stream(bin_call):
    """One two-class binning on the card (M = 48 with the 4x2 small grid, K
    = 128, as RenderConfig.for_scene picks for wider grids) of a captured
    bin_gaussians input whose radii are scaled by 4, so that a share of the
    splats outgrows the small grid: through the tail kernel and through
    the plain tail, equal; returns its sorted stream."""
    from gflow_tpu_torch.ops import binning

    (uv, depth, radius, *rest), kw = bin_call
    args = (uv, depth, 4.0 * radius, *rest)
    kw = dict(kw, max_per_tile=128, max_tiles_per_gaussian=48, small_tiles_per_gaussian=8)
    with capture_binning() as cap:
        got = binning.bin_gaussians(*args, **kw)
    with plain_versions():
        want = binning.bin_gaussians(*args, **kw)
    assert torch.equal(got.tile_lists, want.tile_lists), "two-class tile lists differ"
    assert torch.equal(got.tile_counts, want.tile_counts), "two-class tile counts differ"
    (stream,) = cap["streams"]
    key_s, order, _, nbits, T = stream
    n_small = uv.shape[0] * 8  # the 4x2 grid's entries come first
    large = int(((order >= n_small) & ((key_s >> nbits) < T)).sum())
    assert large > 0, "the large class emitted nothing"
    log(f"# two-class binning (M=48, small 8, K=128, radii x4) of the full stage's first "
        f"projection: kernels == plain; {key_s.shape[0]} entries, {large} live entries of "
        f"the large class, {int(got.large_clamped)} large splats clamped")
    return stream


def log_row(name, K, where, r):
    norm = (f" max err normalized by max |ref| per column {r['max_norm_err']:.3e}"
            if "max_norm_err" in r else "")
    lib = f" library {r['library_ms']:.4f} ms" if r.get("library_ms") is not None else ""
    if "searchsorted_ms" in r:
        lib += f" searchsorted {r['searchsorted_ms']:.4f} ms"
    log(f"# {name} K={K} {where} ({r['live_slots']:.0f} live slots): max_abs_err "
        f"{r['max_abs_err']:.3e}{norm} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")


def build_report():
    """ptxas's registers and spills per compositor kernel, and the resident
    blocks per SM of K1, K2 and K3 at F = 4 (cudaOccupancy...)."""
    import ctypes
    import re

    from gflow_tpu_torch.ops import _build

    kernels, name = {}, None
    for line in _build.BUILD_LOGS.get("composite.cu", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels.setdefault(name, {})["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, {})["regs"] = int(m.group(1))
    report = json.dumps(kernels) if kernels else "no build log (built by an earlier process)"
    log(f"# ptxas composite.cu: {report}")
    fn = _build.library("composite.cu").gflow_composite_occupancy
    fn.argtypes, fn.restype = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p), ctypes.c_int
    occ = {}
    for K in (96, 192):
        info = (ctypes.c_int * 15)()
        rc = fn(K, 4, ctypes.addressof(info))
        assert rc == 0, f"occupancy query failed: cudaError {rc}"
        for i, kname in enumerate(("composite_fwd", "composite_fwd_cov", "composite_bwd")):
            b, regs, local, smem, threads = info[5 * i:5 * i + 5]
            occ[f"{kname} K={K}"] = dict(blocks_per_sm=b, regs=regs, local_bytes=local,
                                         smem_bytes=smem, threads=threads)
    log(f"# occupancy at F=4: {json.dumps(occ)}")
    return kernels, occ


def kernel_phase(main_inputs):
    """Every kernel against its plain version and timed, at K = 96 and 192:
    on synthetic packed inputs and sorted streams, and on the main path's
    own packed input and sorted stream of each stage's first iteration
    (main_inputs); K4 also on one two-class binning."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_tx, n_ty = -(-W // 16), -(-H // 16)
    T, F = n_tx * n_ty, 4
    rows = {}
    # K4's sorted streams: one at M=8 (capacity x 8 entries), the main
    # path's own (the same at every K: K only cuts the lists) and the
    # two-class stream of the full stage's projection
    streams = {"synthetic": synthetic_stream(torch.Generator(device="cuda").manual_seed(1), T),
               **{f"main {stage}": rec["stream"] for stage, rec in main_inputs[96].items()},
               "two-class": two_class_stream(main_inputs[96]["full"]["bin_call"])}
    for K in (96, 192):
        bg = torch.tensor([0.0, 0.0, 0.0, 0.0], device="cuda")
        for with_cov in (False, True):
            name = "composite_fwd_cov" if with_cov else "composite_fwd"
            attrs, counts = packed_inputs(gen, T, K, F, with_cov, n_tx)
            rows[(name, K, "synthetic")] = fwd_row(attrs, counts, bg, n_tx, with_cov)

        # K3 against autograd through the plain version
        attrs, counts = packed_inputs(gen, T, K, F, False, n_tx)
        g = torch.randn((T, 256, F), generator=gen, device="cuda")
        rows[("composite_bwd", K, "synthetic")] = bwd_row(attrs, counts, bg, g, n_tx, False)

        for where, stream in streams.items():
            rows[("bin_tail", K, where)] = tail_row(stream, K, where)

        for stage, rec in main_inputs[K].items():
            a, c, b, nt, cov = (rec[k] for k in ("attrs", "counts", "bg", "n_tx", "with_cov"))
            name = "composite_fwd_cov" if cov else "composite_fwd"
            rows[(name, K, "main")] = fwd_row(a, c, b, nt, cov)
            rows[("composite_bwd", K, f"main {stage}")] = bwd_row(a, c, b, rec["g"], nt, cov)
        for (name, k, where), r in rows.items():
            if k == K:
                log_row(name, K, where, r)
    return rows


@contextmanager
def capture_packed():
    """Record the input of every packed compositor call (and, through a
    hook, the upstream gradient of its image) while the block runs."""
    from gflow_tpu_torch.ops import cuda_raster

    calls, packed = [], cuda_raster.packed_composite

    def record(g_attrs, counts, bg, n_tx, with_cov=False):
        res = packed(g_attrs, counts, bg, n_tx, with_cov)
        rec = dict(attrs=g_attrs.detach().clone(), counts=counts.clone(),
                   bg=bg.detach().clone(), n_tx=n_tx, with_cov=with_cov)
        out = res[0] if with_cov else res
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous().clone()))
        calls.append(rec)
        return res

    with mock.patch.object(cuda_raster, "packed_composite", record):
        yield calls


@contextmanager
def capture_binning():
    """Record the sorted stream of every binning tail (bin_tail's inputs but
    K) and the input of every bin_gaussians call made through ops.render
    while the block runs."""
    from gflow_tpu_torch.ops import binning, render

    got = {"streams": [], "calls": []}
    tail, bin_gaussians = binning.bin_tail, render.bin_gaussians

    def record_tail(key_s, order, idx_flat, nbits, T, K):
        got["streams"].append((key_s.clone(), order.clone(),
                               idx_flat.clone() if isinstance(idx_flat, torch.Tensor)
                               else idx_flat, nbits, T))
        return tail(key_s, order, idx_flat, nbits, T, K)

    def record_call(*args, **kw):
        got["calls"].append((tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                                   for a in args), kw))
        return bin_gaussians(*args, **kw)

    with mock.patch.object(binning, "bin_tail", record_tail), \
         mock.patch.object(render, "bin_gaussians", record_call):
        yield got


def main_path_inputs(scene):
    """The packed compositor input and upstream gradient of the canonical
    frame's first iteration of each stage: camera-only (K2 + K3, CA = 11)
    and full (K1 + K3, CA = 10), from bench.py's scene and targets; at the
    scene's K = 96 and, binned by the same code, at K = 192. Each record
    also holds the iteration's sorted stream ("stream") and bin_gaussians
    input ("bin_call")."""
    import dataclasses

    from gflow_tpu_torch.opt.losses import flow_prior_terms
    from gflow_tpu_torch.opt.state import Params, init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, _forward

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)
    intr = torch.from_numpy(intr).cuda()
    dyn_cam, dyn_full = dynamics()
    n_alive = torch.tensor(n0, dtype=torch.int32, device="cuda")
    state = init_frame_state(CAPACITY)._replace(n_alive=n_alive)
    inputs = {}
    for K in (96, 192):
        inputs[K] = {}
        for stage, camera_only, dyn in (("camera", True, dyn_cam), ("full", False, dyn_full)):
            cfg = StageConfig(W=W, H=H, iterations=1, camera_only=camera_only,
                              render=dataclasses.replace(rcfg, max_per_tile=K))
            prior = flow_prior_terms(state, tg, camera_only, W, H)
            leaves = [x.detach().requires_grad_() for x in params]
            with capture_packed() as calls, capture_binning() as binned:
                total = _forward(Params(*leaves), n_alive, state, tg, intr, dyn.weights, cfg,
                                 flow_prior=prior)[0]
                torch.autograd.grad(total, leaves, allow_unused=True)
            (rec,) = calls
            assert "g" in rec and rec["with_cov"] == camera_only
            (rec["stream"],), (rec["bin_call"],) = binned["streams"], binned["calls"]
            inputs[K][stage] = rec
    return inputs


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def bench_scene():
    """bench.py's scene, built by the port."""
    from scipy.ndimage import gaussian_filter

    from gflow_tpu_torch.opt.initialize import init_params_from_image
    from gflow_tpu_torch.ops.render import RenderConfig

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for c in range(3):
        img[..., c] = gaussian_filter(img[..., c], 8)
    img = (img - img.min()) / (img.max() - img.min())
    depth = (2 + img[..., 0]).astype(np.float32)
    intr = np.asarray([500.0, 500.0, W / 2, H / 2], np.float32)
    extr = np.c_[np.eye(3), np.zeros(3)].astype(np.float32)
    params, n = init_params_from_image(img, depth, N_POINTS, CAPACITY, intr, extr,
                                       rng=rng, device="cuda")
    rcfg = RenderConfig.for_scene(W, H, N_POINTS, image=img)
    assert (rcfg.max_tiles_per_gaussian, rcfg.max_per_tile) == (8, 96), rcfg
    return img, depth, intr, params, n, rcfg


def targets(img, depth, move=None, occ=None):
    from gflow_tpu_torch.opt.state import Targets

    z = torch.zeros((H, W), dtype=torch.bool)
    return Targets(
        image=torch.from_numpy(img).cuda(),
        depth=torch.from_numpy(depth)[..., None].cuda(),
        flow=torch.zeros((H, W, 2), device="cuda"),
        move_mask=(z if move is None else torch.from_numpy(move)).cuda(),
        occ_mask=(z if occ is None else torch.from_numpy(occ)).cuda(),
    )


def dynamics():
    from gflow_tpu_torch.opt.losses import LossWeights
    from gflow_tpu_torch.opt.train import StageDynamics

    weights = LossWeights(rgb=1.0, depth=0.1, var=50.0, flow=0.01)
    cam = StageDynamics(lr=1e-2, lr_camera=1e-3, weights=weights, num_points=N_POINTS)
    full = StageDynamics(lr=1e-3, lr_camera=0.0, weights=weights, num_points=N_POINTS,
                         densify_occ_percent=0.5, densify_err_thre=1e-2,
                         densify_err_percent=1.0)
    return cam, full


@contextmanager
def deterministic():
    """Deterministic algorithms (index_add_ without float atomics) for the
    correctness checks: every run then gives the same numbers, and the
    trajectory check compares the kernels with the plain versions, not with
    the atomics' run-to-run noise (scripts/torch_trajectory_spread.py)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextmanager
def plain_versions():
    """Route the main path through the kernels' plain PyTorch versions (on
    CUDA tensors, for the comparison run only)."""
    from gflow_tpu_torch.ops import binning, composite, cuda_raster

    with mock.patch.object(cuda_raster, "packed_composite", composite.composite_packed), \
         mock.patch.object(binning, "bin_tail", binning.bin_tail_plain):
        yield


def check_targets(img, depth):
    """Targets of the correctness checks: a moving region (so that the next
    frame's camera stage sees movers and K2's coverage does work) and an
    occluded region (so that the occ densify adds points)."""
    move = np.zeros((H, W), bool)
    move[200:320, 300:460] = True
    occ = np.zeros((H, W), bool)
    occ[40:136, 600:696] = True
    return targets(img, depth, move, occ)


def grad_check(scene, tol=5e-4):
    """First-iteration gradients of every parameter leaf through the kernels
    against the plain versions, on the same inputs: the full stage from the
    scene's init (K1 + K3 + K4), and the next frame's camera-only stage
    after the first frame's finalize, with its moving Gaussians (K2 + K3 +
    K4). Each leaf is held normalized by its max |ref| to `tol`. The
    scene's init is isotropic (one scale repeated over the 3 axes), where
    the rotate gradient is zero in exact arithmetic and both paths return
    rounding noise; the check scales each axis by U(0.5, 1.5) so that every
    leaf carries a real gradient. Returns {stage.leaf: normalized error}."""
    from gflow_tpu_torch.opt.losses import flow_prior_terms
    from gflow_tpu_torch.opt.state import Params, init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, _forward, finalize_stage

    img, depth, intr, params, n0, rcfg = scene
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = params._replace(scale=params.scale * (0.5 + torch.rand(
        params.scale.shape, generator=gen, device="cuda")))
    tg = check_targets(img, depth)
    intr = torch.from_numpy(intr).cuda()
    dyn_cam, dyn_full = dynamics()
    n_alive = torch.tensor(n0, dtype=torch.int32, device="cuda")
    s0 = init_frame_state(CAPACITY)._replace(n_alive=n_alive)
    cfg_full = StageConfig(W=W, H=H, iterations=1, render=rcfg)
    cfg_cam = StageConfig(W=W, H=H, iterations=1, camera_only=True, render=rcfg)
    with torch.no_grad():
        aux = _forward(params, n_alive, s0, tg, intr, dyn_full.weights, cfg_full)[1]
    s1 = finalize_stage(aux["uv"], aux["depth"], params, s0, tg.move_mask, n_alive, W, H)
    n_movers = int((~s1.still_mask_tentative[:n0]).sum())
    assert n_movers > 0
    errs = {}
    for stage, cfg, state, dyn in (("full", cfg_full, s0, dyn_full),
                                   ("camera", cfg_cam, s1, dyn_cam)):
        prior = flow_prior_terms(state, tg, cfg.camera_only, W, H)

        def grads():
            leaves = [x.detach().requires_grad_() for x in params]
            total = _forward(Params(*leaves), n_alive, state, tg, intr, dyn.weights, cfg,
                             flow_prior=prior)[0]
            return torch.autograd.grad(total, leaves, allow_unused=True)

        got = grads()
        with plain_versions():
            want = grads()
        for name, g_k, g_p in zip(Params._fields, got, want):
            if g_p is None:  # a leaf the stage does not reach (camera: opacity, rgb)
                assert g_k is None, f"{stage}.{name}"
                continue
            assert torch.isfinite(g_k).all(), f"{stage}.{name}"
            ref = float(g_p.abs().max())
            errs[f"{stage}.{name}"] = (float((g_k - g_p).abs().max()) / ref if ref > 0
                                       else float(g_k.abs().max()))
    log(f"# first-iteration gradients, kernels vs plain versions ({n_movers} movers in "
        f"the camera stage), max err normalized by max |ref| per leaf (tol {tol}): "
        f"{json.dumps(errs)}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, f"gradients differ from the plain path: {bad}"
    return errs


def check_run(scene, max_densify=256, iters=10):
    """Camera-only stage, full stage (occ densify at 0, error densify after
    iteration iters//2 - 1), next frame's camera-only stage; then a render
    of every output. Returns (loss traces, n_alive per stage, params,
    render)."""
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = check_targets(img, depth)
    dyn_cam, dyn_full = dynamics()
    state = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg_cam = StageConfig(W=W, H=H, iterations=iters, camera_only=True, render=rcfg)
    cfg_full = StageConfig(W=W, H=H, iterations=iters, render=rcfg, densify_occ=True,
                           densify_interval=iters // 2, densify_times=1,
                           max_densify=max_densify)
    traces, alive = [], []
    p, s = params, state
    for cfg, dyn in ((cfg_cam, dyn_cam), (cfg_full, dyn_full), (cfg_cam, dyn_cam)):
        p, s, info = train_stage(p, s, tg, intr, gen, cfg, dyn)
        traces.append(info["loss_trace"])
        alive.append(int(info["n_alive"]))
        for k in ("rgb", "depth_map", "uv", "depth"):
            assert torch.isfinite(info[k]).all(), k
    assert info["rgb"].shape == (H, W, 3) and info["depth_map"].shape == (H, W, 1)
    return [t.cpu() for t in traces], alive, p, render_all(scene, p, alive[-1])


def render_all(scene, p, n_alive):
    """Every render output of params p through ops.render."""
    from gflow_tpu_torch.core.camera import pose_to_extr
    from gflow_tpu_torch.ops.render import render
    from gflow_tpu_torch.opt.train import _activate

    intr, rcfg = scene[2], scene[5]
    scale, rotate, opacity, rgb = _activate(p, n_alive)
    out = render(p.xyz, scale, rotate, opacity, rgb, torch.from_numpy(intr),
                 pose_to_extr(p.pose), 0.0, W, H,
                 outputs=("rgb", "depth_map", "depth_map_color", "acc", "center"),
                 config=rcfg)
    return {k: v.detach() for k, v in out.items()}


def main_path(scene):
    """The correctness checks, under deterministic algorithms."""
    with deterministic():
        return _main_path(scene)


def _main_path(scene):
    from gflow_tpu_torch.ops import _build

    img, depth, intr, params, n0, rcfg = scene
    grad_check(scene)
    with plain_versions():
        plain_traces, plain_alive, _, _ = check_run(scene)
    _build.LAUNCHES.clear()
    traces, alive, p, out = check_run(scene)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"# main path launches: {launches}")
    for name in _build.KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched on the main path"

    # both densify events saturate max_densify=256 (occ: 50,000 x 9,216/409,920
    # x 0.5 = 562 points; error: > 0.5% of pixels above 1e-2 at this stage)
    assert alive == [n0, n0 + 512, n0 + 512], alive
    assert alive == plain_alive, (alive, plain_alive)
    for tr in traces:
        assert torch.isfinite(tr).all()
    assert float(traces[1][-1]) < float(traces[1][0]), traces[1]
    # a sanity bound (grad_check holds the gradients tightly): kernel and
    # plain sums differ in order (~1e-6 rel); Adam turns such differences
    # into lr-sized steps where |g| ~ 0, most visibly on the 7 pose
    # parameters of the camera-only stage, so over 10 iterations per stage
    # the loss is held to 1e-2 relative (deterministic, so the same number
    # on every run)
    rel = [float(((tr - ptr).abs() / ptr.abs()).max()) for tr, ptr in zip(traces, plain_traces)]
    for tr, ptr in zip(traces, plain_traces):
        torch.testing.assert_close(tr, ptr, rtol=1e-2, atol=1e-5)
    log(f"# loss trajectory matches plain path (rtol 1e-2; max rel diff per stage "
        f"{rel}): cam {traces[0][0]:.5f}->{traces[0][-1]:.5f} full {traces[1][0]:.5f}->"
        f"{traces[1][-1]:.5f} cam2 {traces[2][0]:.5f}->{traces[2][-1]:.5f}")
    # the same parameters rendered through kernels and plain versions agree
    # to the compositor tolerance
    with plain_versions():
        plain_out = render_all(scene, p, alive[-1])
    for k in out:
        torch.testing.assert_close(out[k], plain_out[k], atol=5e-4, rtol=1e-3)
    log(f"# render {sorted(out)} matches plain path (atol 5e-4, rtol 1e-3)")
    return launches


def time_frame(scene):
    """One frame at the canonical budget, after one warm-up frame."""
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage
    from gflow_tpu_torch.ops import _build

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)  # bench.py: all-false move and occ masks
    dyn_cam, dyn_full = dynamics()
    cfg_cam = StageConfig(W=W, H=H, iterations=150, camera_only=True, render=rcfg)
    cfg_full = StageConfig(W=W, H=H, iterations=300, render=rcfg, densify_occ=True,
                           densify_interval=100, densify_times=2,
                           max_densify=min(CAPACITY, 16384))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = params
    s = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    result = {}
    for frame in ("warmup", "timed"):
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, _ = train_stage(p, s, tg, intr, gen, cfg_cam, dyn_cam)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cam_launches = dict(_build.LAUNCHES)
        p, s, info = train_stage(p, s, tg, intr, gen, cfg_full, dyn_full)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        full_launches = {k: v - cam_launches.get(k, 0) for k, v in _build.LAUNCHES.items()}
        assert torch.isfinite(info["loss_trace"]).all()
        result = dict(cam_ms_per_iter=(t1 - t0) / 150 * 1e3,
                      full_ms_per_iter=(t2 - t1) / 300 * 1e3, s_per_frame=t2 - t0,
                      cam_launches=cam_launches, full_launches=full_launches,
                      n_alive=int(info["n_alive"]))
        log(f"# frame {frame}: {json.dumps(result)}")
    return result


def device_rows(prof):
    """(device us, count, name) of every device kernel in a torch.profiler
    run: device rows only, since an operator's row repeats its kernels'
    time."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_profile(fn, n=20):
    """Device kernels and device ms per call of fn(), from torch.profiler
    over n calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return {"kernels_per_call": "not measured", "device_ms_per_call": "not measured"}
    return {"kernels_per_call": sum(r[1] for r in rows) / n,
            "device_ms_per_call": sum(r[0] for r in rows) / 1e3 / n,
            "kernels": [{"name": k[:90], "calls": c / n, "ms": us / 1e3 / n}
                        for us, c, k in sorted(rows, reverse=True)]}


def profile_binning(main_inputs):
    """The binning layer alone: bin_gaussians, and its tail from the sorted
    stream, on each stage's first-iteration input (the stage runs one
    binning per iteration), from torch.profiler."""
    from gflow_tpu_torch.ops import binning

    out = {}
    for stage, rec in main_inputs[96].items():
        (args, kw), (key_s, order, idx_flat, nbits, T) = rec["bin_call"], rec["stream"]
        K = kw["max_per_tile"]
        out[stage] = {
            "bin_gaussians": device_profile(lambda: binning.bin_gaussians(*args, **kw)),
            "tail": device_profile(lambda: binning.bin_tail(key_s, order, idx_flat, nbits, T, K))}
    log(f"# binning profile per call (one call per iteration): {json.dumps(out)}")
    return out


def profile_iterations(scene, iters=20):
    """Where an iteration's time goes: a full stage of `iters` iterations
    (no densify, the final forward included) from the scene's init, run
    once unprofiled for its wall time and once under torch.profiler for its
    device time. Device busy time is the sum of the device kernels' times;
    the profiler slows the host, so the idle share is taken against the
    unprofiled run of the same stage."""
    from torch.profiler import ProfilerActivity, profile

    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)
    _, dyn_full = dynamics()
    cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg)
    state = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    train_stage(params, state, tg, intr, gen, cfg, dyn_full)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_stage(params, state, tg, intr, gen, cfg, dyn_full)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_stage(params, state, tg, intr, gen, cfg, dyn_full)
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3 / iters
    top = [{"name": k[:70], "ms_per_iter": us / 1e3 / iters, "calls_per_iter": c / iters}
           for us, c, k in sorted(rows, reverse=True)[:12]]
    wall = wall_ms / iters
    summary = {"iters": iters, "profiled_wall_ms_per_iter": profiled_wall_ms / iters,
               "wall_ms_per_iter": wall,
               "device_busy_ms_per_iter": busy if rows else "not measured",
               "device_idle_share": 1.0 - busy / wall if rows else "not measured",
               "device_kernels_per_iter": sum(r[1] for r in rows) / iters, "top": top}
    log(f"# profile (full stage, final forward included): {json.dumps(summary)}")
    return summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from gflow_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"# python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"# nvcc build of {sorted({s for s, _, _ in _build.KERNELS.values()})}: "
        f"{time.perf_counter() - t0:.1f} s")

    build_report()
    scene = bench_scene()
    inputs = main_path_inputs(scene)
    rows = kernel_phase(inputs)
    launches = main_path(scene)
    frame = time_frame(scene)
    log(f"# canonical frame (150 camera + 300 full iterations), {smi}: "
        f"camera {frame['cam_ms_per_iter']:.3f} ms/iter, full {frame['full_ms_per_iter']:.3f} "
        f"ms/iter, {frame['s_per_frame']:.3f} s/frame")
    profile_iterations(scene)
    profile_binning(inputs)

    replaces = {"composite_fwd": "gflow_tpu/ops/pallas_raster.py:127",
                "composite_fwd_cov": "gflow_tpu/ops/pallas_raster.py:127",
                "composite_bwd": "gflow_tpu/ops/pallas_raster.py:172",
                "bin_tail": "gflow_tpu/ops/binning.py:293"}
    kernels = []
    for name, (src, _, _) in _build.KERNELS.items():
        r = rows[(name, 96, "synthetic")]
        row = {"name": name, "route": "cuda", "source": f"gflow_tpu_torch/csrc/{src}",
               "replaces": replaces[name],
               "launches": launches[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if "max_norm_err" in r:  # K3: also the error normalized by max |ref| per column
            row["max_norm_err"] = r["max_norm_err"]
        if "searchsorted_ms" in r:  # K4: the library call for its segment starts alone
            row["searchsorted_ms"] = r["searchsorted_ms"]
        # the same measurements on the main path's own input (K = 96), and
        # K4's on the two-class stream
        keep = ("ms", "bound_ms", "max_abs_err", "library_ms", "searchsorted_ms")
        other = {where: {k: v for k, v in rm.items() if k in keep}
                 for (n, k, where), rm in rows.items()
                 if n == name and k == 96 and where != "synthetic"}
        main = {w: v for w, v in other.items() if w.startswith("main")}
        if main:
            row["main_path_input"] = main
        if "two-class" in other:
            row["two_class_input"] = other["two-class"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
