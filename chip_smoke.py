"""Full-size checks of the PyTorch/CUDA port on the visible GPUs (one
suffices), and the table of its hand-written kernels.

    python3 chip_smoke.py

The card tests (tests/test_torch_cuda.py) hold each kernel and each graph
path against its plain or eager twin at test sizes, and the benchmark
(bench_h100/) times the cells. This script makes the checks that neither
makes, at full size and end to end, and times the kernels:

1. prints the card's name and power limit (nvidia-smi); builds the CUDA
   kernels from ``gflow_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and prints ptxas's registers and spills and the compositor's
   resident blocks per SM;
2. the main path on bench.py's scene (854x480, 50,000 points, capacity
   51,200, M = 8, K = 96): the first iteration's gradients of every
   parameter leaf (the full stage and the next frame's camera-only stage,
   grad_check), the loss trajectory and n_alive of a 3-stage check (a
   camera-only stage, a full stage with an occ and an error densify, the
   next frame's camera-only stage, as CUDA graphs, check_run) and a render
   of every output, each against the same run on the plain PyTorch
   versions on the card; a 20-iteration full stage's loss gap to
   DRIFT_RTOL (drift_check); every kernel of the fit launched, inside graph
   replays too; a 20-iteration full stage with its densifies with stamps
   against the same without, 0 apart (stamp_hold);
3. the tile bands: the band compositor in 4 bands on the main path's own
   packed inputs against the plain band version and the unbanded kernel
   (band_hold), and the 3-stage check with its 30 tile rows in 4 bands as
   CUDA graphs against the unbanded run to BAND_LOSS_RTOL /
   BAND_PARAM_ATOL (banded_phase); the bands over the visible cards, all
   on cuda:0 with one card;
4. one frame at the canonical budget (150 camera + 300 full iterations,
   occ densify at 0 and error densify every 100 x2) as CUDA graphs, for
   its launches;
5. the port's fit_video on a synthetic 4-frame 854x480 sequence (JPEG
   frames, 3 frames fitted, depth cut to FIT) with 50,000 points: the log
   directory (checkpoint schema, videos, pickles), the final PSNR above
   PSNR_FLOOR and the move segmentation; the stamp kernel 5 times an
   iteration and ssim_bwd once; the final checkpoint rendered
   (render_scene) and the trajectory line set drawn through the kernels
   and through the plain versions (hold_renders), and the checkpoint loaded
   into a trainer renders the same;
6. the port's benchmark (eval.benchmark.main: the four suites, LPIPS with
   seeded random weights) on that fit, on the card and again on the plain
   versions: PSNR, J, F, ATE and RPE identical, OA / AJ / APTS within one
   query-frame's share, SSIM and LPIPS within 1e-5 relative of the CPU's;
7. the port's viewer (viz.viewer.ViewerState) on that fit: every frame in
   follow mode, one orbit and one free 6-DoF pose against the plain
   versions to 1e-5 (hold_composite: but for the rare pixel where a slot's
   alpha sits on its 1/255 step, or where the float32 rounding of the
   blend accounts for the difference), and /info and /render over HTTP on
   127.0.0.1;
8. the prior preparation as a user runs it, on a second 4-frame sequence:
   prep_flow (GMFlow at the released width), prep_moveseg (the LMedS) and
   prep_depth (MASt3R catmlp+dpt ViT-L at 512x288, 10 pairs, the 700-step
   global alignment), each compiled path as CUDA graphs; each model, the
   occlusion and the error map against the CPU; no K1-K4 launched and
   small_eig 4 times a frame; prep_flow and prep_depth with --mesh-devices
   2 (replicas over the visible cards) against 0 (prep_mesh_hold);
9. one 64-prompt SAM mask decode (prep_mask.decode's graph), for its
   launches; prep_track (SAM 2.1 Hiera-L at the released widths) on a
   4-frame 854x480 sequence, twice, the second run's launches counted;
10. fit_multi on max(2, count) copies of the fit_video sequence in spawned
   workers (the PSNR floor; their launches are the workers'), and with two
   or more cards fit_video(shard_devices=count) end to end;
11. the kernel table (KERNEL_TABLE): each kernel against its plain version
   and timed (device ms by CUDA-graph replay, the plain version's ms, the
   least time on the benchmark's peaks) at the canonical shapes and on the
   main path's own inputs; printed as the kernels JSON line, each kernel
   with its launches on every path above (LAUNCHES_BY_PATH, 0 where it
   does not run), then as the last line {"ok": true, "device": {...}}.

Any failure raises and exits nonzero. A failing kernel-vs-plain hold of
the compositor (hold_composite) first saves its call under
logs/chip_smoke/hold_failures/ (scripts/torch_replay_composite.py replays
it). Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
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

from bench_h100.harness.device import PEAK_BYTES, PEAK_FP32_FLOPS, least_seconds
from bench_h100.work.composite import ops_k1, ops_k2, ops_k3

# fp32 throughout, as the reference (Precision.HIGHEST); the plain
# compositor's einsum must not drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# cuBLAS needs a fixed workspace for the deterministic checks (deterministic())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

W, H = 854, 480
N_POINTS, CAPACITY = 50_000, 51_200
# the fit's kernels (K1-K4); small_eig runs on the prep path only
FIT_KERNELS = ("composite_fwd", "composite_fwd_cov", "composite_bwd", "bin_tail")
# fp32 operations per (pixel, channel) of SSIM, counted from csrc/ssim.cu:
# forward x^2 y^2 xy 3, five maps x 11 taps x 2 passes x (mul, add) 220, the
# map 17, the coefficient maps 14, the mean 1; backward three maps x 11
# taps x 2 passes x 2 = 132, the combination 6. Bytes: x and y in and the
# three maps out (forward); the maps, x and y in and dL/dx out (backward)
OPS_SSIM_FWD, OPS_SSIM_BWD = 255, 138
BYTES_SSIM_FWD, BYTES_SSIM_BWD = 4 * 5, 4 * 6
# each path's kernel launches, by path and kernel (counted())
LAUNCHES_BY_PATH: dict = {}


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
    """The least time in ms on the benchmark's peaks, and which of the
    operations and the bytes sets it."""
    by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    return least_seconds(flops, nbytes) * 1e3, by


@contextmanager
def counted(path):
    """Count the kernel launches of the block as `path`'s in
    LAUNCHES_BY_PATH (the counters reset just before, read just after)."""
    from gflow_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    yield
    torch.cuda.synchronize()
    LAUNCHES_BY_PATH[path] = dict(_build.LAUNCHES)


# ---------------------------------------------------------------------------
# the kernels against their plain versions
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


def cutoff_bound(rec, t, p, rel=1e-4):
    """How far alpha's two steps may move pixel p[i] of tile t[i] of the
    packed compositor input rec between two fp32 evaluations. alpha is 0
    below the 1/255 cutoff and where power > 0; the kernel contracts power
    into FMAs and the plain version rounds each product, so a live slot whose
    alpha lies within `rel` of the cutoff (or whose |power| is within `rel`
    of 0) may be kept by one and dropped by the other. Slot k of alpha a so
    flipped moves the pixel by a T_k (f_k - rest), |rest| <= T_k max(|f|,
    |bg|): at most 2 a max(|f|, |bg|). Returns that bound summed over such
    slots per pixel, 0 where no slot sits at a step."""
    from gflow_tpu_torch.ops.composite import tile_pixels
    from gflow_tpu_torch.ops.reference import ALPHA_CLAMP, ALPHA_SKIP

    attrs, counts = rec["attrs"], rec["counts"]
    T, K, CA = attrs.shape
    F = CA - 6 - int(rec["with_cov"])
    px, py = tile_pixels(T, rec["n_tx"], attrs.device, rec.get("row0", 0))
    a = attrs[t]  # (n, K, CA)
    dx = px[t, p][:, None] - a[..., 0]
    dy = py[t, p][:, None] - a[..., 1]
    power = -0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy) - a[..., 3] * dx * dy
    alpha = torch.clamp_max(a[..., 5] * torch.exp(power.clamp_max(0.0)), ALPHA_CLAMP)
    live = torch.arange(K, device=attrs.device)[None, :] < counts[t][:, None]
    at_step = live & (((alpha / ALPHA_SKIP - 1).abs() <= rel) | (power.abs() <= rel))
    fmax = max(float(attrs[..., 6:6 + F].abs().max()), float(rec["bg"].abs().max()))
    return 2 * fmax * (at_step * alpha).sum(1)


U32 = 2.0 ** -24  # float32's unit roundoff


def pixel_slots(rec, t, p):
    """The slots of the packed compositor call rec at pixel p[i] of tile
    t[i], in float64, each (n, K): power, terms (|a dx^2| / 2 + |c dy^2| /
    2 + |b dx dy|, the sum of |power|'s terms: float32 rounds power to
    about 1e-7 of it), alpha (0 where the slot is dead, power > 0 or alpha
    lies more than 1e-4 below its 1/255 step) and blend weight T alpha."""
    from gflow_tpu_torch.ops.composite import tile_pixels
    from gflow_tpu_torch.ops.reference import ALPHA_CLAMP, ALPHA_SKIP

    attrs, K = rec["attrs"], rec["attrs"].shape[1]
    px, py = tile_pixels(attrs.shape[0], rec["n_tx"], attrs.device, rec.get("row0", 0))
    a = attrs[t].double()  # (n, K, CA)
    dx = px[t, p].double()[:, None] - a[..., 0]
    dy = py[t, p].double()[:, None] - a[..., 1]
    terms = ((0.5 * a[..., 2] * dx * dx).abs() + (0.5 * a[..., 4] * dy * dy).abs()
             + (a[..., 3] * dx * dy).abs())
    power = -0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy) - a[..., 3] * dx * dy
    alpha = torch.clamp_max(a[..., 5] * torch.exp(power.clamp_max(0.0)), ALPHA_CLAMP)
    live = torch.arange(K, device=attrs.device)[None, :] < rec["counts"][t][:, None]
    alpha = torch.where(live & (power <= 0) & (alpha >= ALPHA_SKIP * (1 - 1e-4)), alpha, 0.0)
    weight = alpha * torch.cumprod(torch.cat([alpha.new_ones(alpha.shape[0], 1),
                                              1 - alpha[:, :-1]], 1), 1)
    return {"power": power, "terms": terms, "alpha": alpha, "weight": weight}


def rounding_bound(rec, t, p):
    """How far one float32 evaluation of the packed compositor call rec may
    lie from the exact blend at pixel p[i] of tile t[i], to first order in
    u = 2^-24. Only the n slots lit there (pixel_slots' alpha > 0, those
    within 1e-4 below alpha's step included) round: a slot of alpha 0
    multiplies T by 1 and adds 0, both exact. Then, with f = max(|f_k|
    lit, |bg|):
    - the blend: T_k takes k factors (1 - alpha_j), each rounded, and k
      products, w_k = alpha_k T_k and w_k f_k one rounding each, so
      sum_k |w_k f_k| (2n + 2) u <= (2n + 2) u f; the running sum of n + 1
      terms, each partial at most f, adds (n + 1) u f; in all (3n + 3) u f,
      and one more u f for T_final bg: (3n + 4) u f;
    - the alphas: power = -(a dx^2 + c dy^2) / 2 - b dx dy rounds dx and
      dy once each and every product and sum once, so by at most 6 u
      terms_k (which an ill-conditioned splat makes large against
      |power|); exp (within 2 ulps) and the opacity's product add 5 u;
      alpha_k moves relatively by that, and the pixel by T_k |f_k -
      rest_k| <= 2 f T_k per unit of alpha_k: 2 f sum_k w_k (6 terms_k +
      5) u.
    Returns u f (3n + 4 + 2 sum_k w_k (6 terms_k + 5)) per pixel (float64):
    two evaluations, the kernel and the plain version, lie at most twice
    that apart."""
    F = rec["attrs"].shape[2] - 6 - int(rec["with_cov"])
    slots = pixel_slots(rec, t, p)
    lit = slots["alpha"] > 0
    f = torch.where(lit[..., None], rec["attrs"][t][..., 6:6 + F].double().abs(), 0.0)
    f = torch.maximum(f.amax((1, 2)), rec["bg"].double().abs().max())
    return U32 * f * (3 * lit.sum(1) + 4 + 2 * (slots["weight"] * (6 * slots["terms"] + 5)).sum(1))


def unexplained(rec, got, want, t, p, n=4):
    """What a failed hold_composite reports of its first n unexplained
    pixels: tile and pixel, the kernel's and the plain version's values
    and their distance from the same function in float64, the live slots,
    the float32 rounding bound (rounding_bound) and, of the slots with
    blend weight > 1e-3, the largest sum of |power|'s terms
    (pixel_slots)."""
    from gflow_tpu_torch.ops import composite

    attrs, counts = rec["attrs"], rec["counts"]
    res = composite.composite_packed(attrs.double(), counts, rec["bg"].double(), rec["n_tx"],
                                     rec["with_cov"], rec.get("row0", 0))
    ref = res[0] if rec["with_cov"] else res
    t, p = t[:n], p[:n]
    rounding = rounding_bound(rec, t, p).tolist()
    slots = pixel_slots(rec, t, p)
    terms = torch.where(slots["weight"] > 1e-3, slots["terms"], 0.0).amax(1).tolist()
    return [{"tile": ti, "pixel": pi, "kernel": got[ti, pi].tolist(),
             "plain": want[ti, pi].tolist(),
             "kernel_vs_f64": float((got[ti, pi].double() - ref[ti, pi]).abs().max()),
             "plain_vs_f64": float((want[ti, pi].double() - ref[ti, pi]).abs().max()),
             "live_slots": int(counts[ti]), "rounding_bound": rounding[i],
             "max_terms_weighted": terms[i]}
            for i, (ti, pi) in enumerate(zip(t.tolist(), p.tolist()))]


def hold_composite(got, want, rec, atol, rtol, max_share=1e-4, phase="kernels", view="call"):
    """Hold the (T, P, F) output of one packed compositor call on rec
    against its plain version: every element within atol + rtol |want|,
    except at pixels where what two float32 evaluations of the blend may
    differ by accounts for the difference: a slot at one of alpha's steps
    (cutoff_bound) plus twice the pixel's float32 rounding (rounding_bound:
    the kernel and the plain version each lie within it of the exact
    blend); such pixels may be at most max_share of the pixels. A failing
    hold first saves the call (save_hold_failure, named by phase and view),
    then raises naming the file. Returns (max abs error, pixels past the
    tolerance)."""
    diff = (got - want).abs()
    tol = atol + rtol * want.abs()
    t, p = (diff > tol).any(-1).nonzero(as_tuple=True)
    if t.numel():
        over = (diff - tol)[t, p].amax(-1)
        bound = cutoff_bound(rec, t, p) + 2 * rounding_bound(rec, t, p).to(over.dtype)
        msg = f"{t.numel()} pixels past atol {atol} rtol {rtol}, by up to {float(over.max()):.3g}"
        odd = ~(over <= bound)  # a NaN is not explained
        if bool(odd.any()):
            path = save_hold_failure(rec, got, want, atol, rtol, t[odd], p[odd], phase, view)
            raise AssertionError(
                f"{msg}; not explained by alpha's steps or float32 rounding at "
                f"{int(odd.sum())} of them (the call saved to {path}): "
                f"{json.dumps(unexplained(rec, got, want, t[odd], p[odd]))}")
        if t.numel() > max_share * diff.shape[0] * diff.shape[1]:
            path = save_hold_failure(rec, got, want, atol, rtol, t, p, phase, view)
            raise AssertionError(f"{msg}: too many (the call saved to {path})")
    return float(diff.max()), int(t.numel())


def save_hold_failure(rec, got, want, atol, rtol, t, p, phase, view):
    """torch.save one failed hold_composite call to
    HOLD_FAILURES/<phase>-<view>.pt: the compositor's input (attrs, counts,
    bg, n_tx, with_cov, row0), the held outputs got / want, the tolerance,
    the failing pixels (tile t, pixel p), the phase and the view; returns
    the path. scripts/torch_replay_composite.py replays it."""
    import re

    os.makedirs(HOLD_FAILURES, exist_ok=True)
    path = os.path.join(HOLD_FAILURES, re.sub(r"[^\w.=-]+", "_", f"{phase}-{view}") + ".pt")
    cpu = lambda x: x.detach().cpu() if torch.is_tensor(x) else x
    torch.save({"attrs": cpu(rec["attrs"]), "counts": cpu(rec["counts"]), "bg": cpu(rec["bg"]),
                "n_tx": int(rec["n_tx"]), "with_cov": bool(rec["with_cov"]),
                "row0": int(rec.get("row0", 0)), "got": cpu(got), "want": cpu(want),
                "atol": atol, "rtol": rtol, "tiles": cpu(t), "pixels": cpu(p),
                "phase": phase, "view": view}, path)
    return path


def hold_renders(draw, atol, rtol, phase):
    """draw() through the kernels and through the plain versions, each
    packed compositor call of the first run held against the same call of
    the second (hold_composite; binning is exact, so both give the
    compositor the same input). Both run eagerly (disable_graphs), where
    capture_packed sees every call as it runs. Returns both runs' results,
    the calls of the first, and the pixels at one of alpha's steps per
    call."""
    from gflow_tpu_torch.opt.graphs import disable_graphs

    with disable_graphs(), capture_packed() as calls:
        got = draw()
    with disable_graphs(), plain_versions(), capture_packed() as plain_calls:
        want = draw()
    assert len(calls) == len(plain_calls), (len(calls), len(plain_calls))
    steps = []
    for i, (rec, plain) in enumerate(zip(calls, plain_calls)):
        assert torch.equal(rec["attrs"], plain["attrs"]) and torch.equal(
            rec["counts"], plain["counts"]), "the compositor's inputs differ"
        steps.append(hold_composite(rec["out"], plain["out"], rec, atol, rtol, phase=phase,
                                    view=f"call {i}")[1])
    return got, want, calls, steps


def image_tiles(img, n_tx):
    """(H, W, C) image -> (T, P, C) per-tile pixels, zero-padded to whole
    tiles (the inverse of composite.untile)."""
    h, w, C = img.shape
    n_ty = -(-h // 16)
    pad = img.new_zeros(n_ty * 16, n_tx * 16, C)
    pad[:h, :w] = img
    return pad.reshape(n_ty, 16, n_tx, 16, C).permute(0, 2, 1, 3, 4).reshape(-1, 256, C)


def fwd_row(attrs, counts, bg, n_tx, with_cov, where):
    """K1 (with_cov False) or K2 against its plain version on one packed
    input (`where` names it): error, kernel / plain / bound times."""
    from gflow_tpu_torch.ops import composite, cuda_raster

    T, K, CA = attrs.shape
    F = CA - 6 - int(with_cov)
    live = float(counts.sum())
    got = cuda_raster.composite_fwd(attrs, counts, bg, n_tx, with_cov)
    want = composite.composite_packed(attrs, counts, bg, n_tx, with_cov)
    got, want = (got, want) if with_cov else ((got,), (want,))
    torch.cuda.synchronize()
    rec = dict(attrs=attrs, counts=counts, bg=bg, n_tx=n_tx, with_cov=with_cov)
    err, _ = hold_composite(got[0], want[0], rec, atol=5e-4, rtol=1e-3, phase="kernels",
                            view=f"{'K2' if with_cov else 'K1'} K={K} F={F} {where}")
    if with_cov:
        torch.testing.assert_close(got[1], want[1], atol=5e-4, rtol=1e-3)
        err = max(err, float((got[1] - want[1]).abs().max()))
        # coverage support must agree exactly where it is clear
        clear = (want[1] - 0).abs() > 1e-3
        assert torch.equal((got[1] > 0)[clear], (want[1] > 0)[clear])
    ms = kernel_ms(lambda: cuda_raster.composite_fwd(attrs, counts, bg, n_tx, with_cov))
    plain_ms = cuda_ms(lambda: composite.composite_packed(attrs, counts, bg, n_tx, with_cov),
                       reps=5)
    ops = live * 256 * (ops_k2(F) if with_cov else ops_k1(F))
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
    b_ms, b_by = bound(live * 256 * ops_k3(F),
                       4 * (live * CA + T + F + T * 256 * F + T * K * CA))
    return dict(max_abs_err=err, max_norm_err=norm_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, live_slots=live)


def compositor_rows(inputs):
    """K1 (composite_fwd), K2 (composite_fwd_cov) and K3 (composite_bwd),
    each against its plain version and timed at K = 96 and 192: on a
    synthetic packed input (T = 1620 tiles of the 854x480 frame, F = 4) and
    on the main path's own input of each stage that runs it; K1 also at K =
    128 on the eval's (F = 2) and the viewer's (F = 3) own input. Returns
    {kernel: {input: row}}."""
    n_tx = -(-W // 16)
    T = n_tx * -(-H // 16)
    bg = torch.zeros(4, device="cuda")
    fwd = {False: "composite_fwd", True: "composite_fwd_cov"}
    rows = {"composite_fwd": {}, "composite_fwd_cov": {}, "composite_bwd": {}}
    for K in (96, 192):
        for cov, name in fwd.items():
            gen = torch.Generator(device="cuda").manual_seed(K)
            attrs, counts = packed_inputs(gen, T, K, 4, cov, n_tx)
            rows[name][f"synthetic K={K}"] = fwd_row(attrs, counts, bg, n_tx, cov, "synthetic")
            if not cov:
                g = torch.randn((T, 256, 4), generator=gen, device="cuda")
                rows["composite_bwd"][f"synthetic K={K}"] = bwd_row(attrs, counts, bg, g, n_tx,
                                                                    False)
    for K in (96, 192):
        for stage, rec in inputs["main"][K].items():
            a, c, b, nt, rc = (rec[k] for k in ("attrs", "counts", "bg", "n_tx", "with_cov"))
            rows[fwd[rc]][f"main {stage} K={K}"] = fwd_row(a, c, b, nt, rc, f"main {stage}")
            rows["composite_bwd"][f"main {stage} K={K}"] = bwd_row(a, c, b, rec["g"], nt, rc)
    for where in ("eval", "viewer"):
        rec = inputs[where]
        where = f"{where} F={rec['attrs'].shape[2] - 6}"
        rows["composite_fwd"][f"{where} K=128"] = fwd_row(rec["attrs"], rec["counts"], rec["bg"],
                                                          rec["n_tx"], False, where)
    return rows


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


def tail_rows(inputs):
    """K4 (bin_tail) against its plain version (torch.equal) and timed at K
    = 96 and 192: on a synthetic stream, on each stage's own sorted stream
    of the main path and on one two-class binning of the full stage's
    projection; at K = 128 on the eval's two-class stream."""
    T = -(-W // 16) * -(-H // 16)
    streams = {"synthetic": synthetic_stream(torch.Generator(device="cuda").manual_seed(1), T),
               **{f"main {stage}": rec["stream"] for stage, rec in inputs["main"][96].items()},
               "two-class": two_class_stream(inputs["main"][96]["full"]["bin_call"])}
    rows = {f"{where} K={K}": tail_row(stream, K, where)
            for K in (96, 192) for where, stream in streams.items()}
    rows["eval two-class K=128"] = tail_row(inputs["eval_stream"], 128, "eval two-class")
    return {"bin_tail": rows}


def ssim_rows(inputs, shape=(H, W, 3)):
    """ssim_fwd and ssim_bwd against the plain version on the fit's image
    shape: the mean SSIM's error, dL/dimg1's normalized by its max |ref|
    (1e-5: tests/test_torch_cuda.py); each kernel's device time beside its
    bound and the plain forward's (ssim_fwd: the forward with its
    coefficient maps) or forward + backward's (ssim_bwd)."""
    from gflow_tpu_torch.ops import ssim as ssim_ops

    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(shape, generator=gen, device="cuda")
    y = (0.7 * x + 0.3 * torch.rand(shape, generator=gen, device="cuda")).clamp(0, 1)
    n = x.numel()
    got, coef = ssim_ops.ssim_fwd(x, y, with_coef=True)
    want = ssim_ops.ssim_plain(x, y)

    def grad(fn):
        leaf = x.detach().requires_grad_()
        return torch.autograd.grad(1.0 - fn(leaf, y), leaf)[0]

    g_k, g_p = grad(ssim_ops.ssim), grad(ssim_ops.ssim_plain)
    torch.cuda.synchronize()
    err, g_err = abs(float(got) - float(want)), float((g_k - g_p).abs().max())
    norm_err = g_err / float(g_p.abs().max())
    assert err <= 1e-6 and norm_err <= 1e-5, (err, norm_err)
    one = torch.ones((), device="cuda")
    timed = {
        "ssim_fwd": (lambda: ssim_ops.ssim_fwd(x, y, with_coef=True),
                     lambda: ssim_ops.ssim_plain(x, y), OPS_SSIM_FWD, BYTES_SSIM_FWD, err),
        "ssim_bwd": (lambda: ssim_ops.ssim_bwd(x, y, coef, one),
                     lambda: grad(ssim_ops.ssim_plain), OPS_SSIM_BWD, BYTES_SSIM_BWD, g_err),
    }
    rows = {}
    for name, (kernel, plain, ops, nbytes, e) in timed.items():
        b_ms, b_by = bound(n * ops, n * nbytes)
        rows[name] = {"x".join(map(str, shape)): dict(
            ms=kernel_ms(kernel), plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=e, max_norm_err=norm_err)}
    return rows


# SAM's mask decoder at the automatic grid's batch: 64 prompts, a 64 x 64
# grid of 256 channels, 7 tokens, cross attention 8 heads of 16
SAM_B, SAM_GRID, SAM_C, SAM_I, SAM_T = 64, 64, 256, 128, 7


def sam_decoder_work(B, N, C=SAM_C, I=SAM_I, T=SAM_T, image_each=False, dense_cells=False):
    """fp32 operations and bytes each image-stream kernel's function needs
    (each input byte read once, each output written once), by kernel name.
    An attention: per (prompt, token, head, image row) a dot of 16 and a
    weighted sum of 16 (4 I a (token, row) pair), the scale, max, exp and
    sum (~5 a head); the norm ~10 a value; stream_init one add a value, its
    image (C, N) or with image_each (B, C, N), its dense prompt (C,) or with
    dense_cells (B, C, N) (SAM 2's tracked and prompted frames)."""
    att_ops = B * T * N * (4 * I + 5 * 8)
    each = image_each or dense_cells
    init_in = (B if image_each else 1) * C * N + (B * C * N if dense_cells else C) + N * C
    return {
        "sam_stream_init": ((B if each else 1) * C * N + B * N * C,
                            4 * (init_in + 2 * B * N * C)),
        "sam_t2i_attend": (att_ops, 4 * (2 * B * T * I + 2 * B * N * I)),
        "sam_i2t_attend": (att_ops, 4 * (2 * B * N * I + 2 * B * T * I)),
        "sam_residual_ln": (10 * B * N * C, 4 * (4 * B * N * C + N * C + 2 * C)),
    }


def sam_rows(inputs):
    """The decoder's four image-stream kernels (ops/sam_decoder.py), each
    against its plain version at the grid's shapes, and sam_stream_init
    also at SAM 2's (3 objects: an image each, as on a tracked frame; one
    image and a dense prompt a cell, as on the prompted frame): max error,
    also relative to the largest value (1e-5), device ms beside the bytes'
    bound and the plain version's ms; for the attentions also torch's
    scaled_dot_product_attention on head-major copies made beforehand
    (library_ms: a yardstick the port never calls)."""
    from functools import partial

    import torch.nn.functional as F

    from gflow_tpu_torch.ops import sam_decoder as sd

    B, N, heads, O = SAM_B, SAM_GRID ** 2, 8, 3

    def seeded():
        g = torch.Generator(device="cuda").manual_seed(6)
        return lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale

    r = seeded()
    image, dense, pe = r(1, SAM_C, SAM_GRID, SAM_GRID), r(SAM_C), r(N, SAM_C)
    images, denses = r(O, SAM_C, SAM_GRID, SAM_GRID), r(O, SAM_C, SAM_GRID, SAM_GRID)
    r = seeded()
    ln_args = (r(B, N, SAM_C), r(B, N, SAM_C), r(SAM_C), r(SAM_C), 1e-5, r(N, SAM_C))
    shape = f"B {B}, N {N}, C {SAM_C}, T {SAM_T}"
    work, work_o = sam_decoder_work(B, N), f"B {O}, N {N}, C {SAM_C}"
    # (kernel, input, kernel call, plain version, library call's head-major
    # inputs or None, (operations, bytes))
    calls = [("sam_stream_init", shape, partial(sd.stream_init, image, dense, pe, B),
              partial(sd.stream_init_plain, image, dense, pe, B), None,
              work["sam_stream_init"]),
             ("sam_stream_init", f"{work_o}, an image a prompt",
              partial(sd.stream_init, images, dense, pe, O),
              partial(sd.stream_init_plain, images, dense, pe, O), None,
              sam_decoder_work(O, N, image_each=True)["sam_stream_init"]),
             ("sam_stream_init", f"{work_o}, one image, a dense prompt a cell",
              partial(sd.stream_init, image, denses, pe, O),
              partial(sd.stream_init_plain, image, denses, pe, O), None,
              sam_decoder_work(O, N, dense_cells=True)["sam_stream_init"]),
             ("sam_residual_ln", shape, partial(sd.residual_ln, *ln_args),
              partial(sd.residual_ln_plain, *ln_args), None, work["sam_residual_ln"])]
    # the tokens over the image's rows, and the rows over the tokens
    for name, attend, n_q, n_keys in (("sam_t2i_attend", sd.t2i_attend, SAM_T, N),
                                      ("sam_i2t_attend", sd.i2t_attend, N, SAM_T)):
        r = seeded()
        q, k, v = r(B, n_q, SAM_I, scale=2.0), r(B, n_keys, SAM_I), r(B, n_keys, SAM_I)
        calls.append((name, shape, partial(attend, q, k, v, heads),
                      partial(sd.cross_attend_plain, q, k, v, heads),
                      tuple(t.reshape(*t.shape[:2], heads, -1).transpose(1, 2).contiguous()
                            for t in (q, k, v)), work[name]))
    out = {}
    for name, where, kernel, plain, lib, (ops, nbytes) in calls:
        got, want = kernel(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(float((a - c).abs().max()) for a, c in zip(got, want))
        rel = max(float((a - c).abs().max() / c.abs().max()) for a, c in zip(got, want))
        assert rel <= 1e-5, (name, where, rel)
        b_ms, b_by = bound(ops, nbytes)
        row = dict(ms=kernel_ms(kernel), plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms,
                   bound_by=b_by, max_abs_err=err, max_rel_err=rel,
                   library_ms=kernel_ms(lambda: F.scaled_dot_product_attention(*lib))
                   if lib else None)
        row["roofline_pct"] = 100 * b_ms / row["ms"]
        out.setdefault(name, {})[where] = row
    return out


def stamp_rows(inputs):
    """stamp, one launch: two stamps in a row write nondecreasing positive
    times of the card's timer; its device time beside its bound (the row
    index read, one int64 written). Its plain version writes the host's
    clock into a CPU table: there is no plain call on the card to time."""
    from gflow_tpu_torch.ops.stamp import stamp

    it = torch.zeros(1, dtype=torch.int64, device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int64, device="cuda")
    stamp(it, table, 0)
    stamp(it, table, 1)
    t0, t1 = table[0].tolist()
    assert 0 < t0 <= t1, (t0, t1)
    b_ms, b_by = bound(0.0, 16.0)
    return {"stamp": {"one launch": dict(ms=kernel_ms(lambda: stamp(it, table, 0)),
                                         plain_ms=None, bound_ms=b_ms, bound_by=b_by,
                                         max_abs_err=None)}}


def build_report():
    """ptxas's registers and spills per compositor kernel and per small_eig
    instantiation, and the resident blocks per SM of K1, K2 and K3 at F =
    4 (cudaOccupancy...)."""
    import ctypes
    import re

    from gflow_tpu_torch.ops import _build

    def ptxas(source):
        kernels, name = {}, None
        for line in _build.BUILD_LOGS.get(source, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                kernels.setdefault(name, {})["spill"] = f"{m.group(1)}/{m.group(2)}"
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                kernels.setdefault(name, {})["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m and name:
                kernels.setdefault(name, {})["smem"] = int(m.group(1))
        report = json.dumps(kernels) if kernels else "no build log (built by an earlier process)"
        log(f"# ptxas {source}: {report}")
        return kernels

    kernels = ptxas("composite.cu")
    ptxas("ssim.cu")
    eig = small_eig_ptxas(_build.BUILD_LOGS.get("small_eig.cu", ""))
    log(f"# ptxas small_eig.cu by n: {json.dumps(eig) if eig else 'no build log'}")
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


@contextmanager
def capture_packed():
    """Record the input and the (T, P, F) output of every packed compositor
    call (and, through a hook, the upstream gradient of its image) while the
    block runs."""
    from gflow_tpu_torch.ops import cuda_raster

    calls, packed = [], cuda_raster.packed_composite

    def record(g_attrs, counts, bg, n_tx, with_cov=False, row0=0):
        res = packed(g_attrs, counts, bg, n_tx, with_cov, row0)
        out = res[0] if with_cov else res
        rec = dict(attrs=g_attrs.detach().clone(), counts=counts.clone(),
                   bg=bg.detach().clone(), n_tx=n_tx, with_cov=with_cov, row0=row0,
                   out=out.detach().clone())
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


PLAIN_PARTS = ("fwd", "bwd", "tail", "ssim")  # K1/K2, K3, K4, ssim_fwd/ssim_bwd


class _SwappedComposite(torch.autograd.Function):
    """The packed compositor on CUDA tensors with one half as its plain
    version: plain_fwd runs the plain forward and K3 backward; otherwise
    K1/K2 forward and the plain forward's autograd backward (K3 swapped)."""

    @staticmethod
    def forward(ctx, g_attrs, counts, bg, n_tx, with_cov, row0, plain_fwd):
        from gflow_tpu_torch.ops import composite, cuda_raster

        ctx.save_for_backward(g_attrs, counts, bg)
        ctx.args = (n_tx, with_cov, row0, plain_fwd)
        fwd = composite.composite_packed if plain_fwd else cuda_raster.composite_fwd
        res = fwd(g_attrs, counts, bg, n_tx, with_cov, row0)
        if with_cov:
            ctx.mark_non_differentiable(res[1])
        return res

    @staticmethod
    def backward(ctx, g_out, *unused):
        from gflow_tpu_torch.ops import composite, cuda_raster

        g_attrs, counts, bg = ctx.saved_tensors
        n_tx, with_cov, row0, plain_fwd = ctx.args
        if plain_fwd:
            d = cuda_raster.composite_bwd(g_attrs, counts, bg, g_out, n_tx, with_cov, row0)
        else:
            with torch.enable_grad():
                a = g_attrs.detach().requires_grad_()
                out = composite.composite_packed(a, counts, bg, n_tx, with_cov, row0)
                d = torch.autograd.grad(out[0] if with_cov else out, a, g_out)[0]
        return d, None, None, None, None, None, None


@contextmanager
def plain_versions(parts=PLAIN_PARTS):
    """Route the main path through the kernels' plain PyTorch versions (on
    CUDA tensors, for the comparison run only): all of them, or those of
    `parts` alone ("fwd": K1/K2, "bwd": K3, "tail": K4, "ssim": the loss's
    and the eval's SSIM)."""
    from gflow_tpu_torch.eval import metrics
    from gflow_tpu_torch.ops import binning, composite, cuda_raster
    from gflow_tpu_torch.ops.ssim import ssim_plain
    from gflow_tpu_torch.opt import losses

    parts = set(parts)
    assert parts <= set(PLAIN_PARTS), parts
    with contextlib.ExitStack() as stack:
        if {"fwd", "bwd"} <= parts:
            stack.enter_context(mock.patch.object(cuda_raster, "packed_composite",
                                                  composite.composite_packed))
        elif parts & {"fwd", "bwd"}:
            plain_fwd = "fwd" in parts
            stack.enter_context(mock.patch.object(
                cuda_raster, "packed_composite",
                lambda g_attrs, counts, bg, n_tx, with_cov=False, row0=0: _SwappedComposite.apply(
                    g_attrs, counts, bg, n_tx, with_cov, row0, plain_fwd)))
        if "tail" in parts:
            stack.enter_context(mock.patch.object(binning, "bin_tail", binning.bin_tail_plain))
        if "ssim" in parts:
            stack.enter_context(mock.patch.object(losses, "ssim", ssim_plain))
            stack.enter_context(mock.patch.object(metrics, "_ssim", ssim_plain))
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


# The kernel-vs-plain gap of a lean full stage grows with its length: Adam
# turns rounding differences into lr-sized steps where a gradient is ~0.
# scripts/torch_stage_spread.py measured it on NVIDIA H100 80GB HBM3 cards at
# 700.00 W, deterministic, as the largest relative loss gap over the trace:
# all kernels against all plain versions 7.3e-7 / 3.8e-3 / 1.8e-2 / 2.6e-2
# at 10 / 20 / 100 / 300 iterations; the plain versions on the card against
# the same plain versions on the CPU (no kernel in either) 1.5e-6 / 3.0e-3 /
# 2.2e-2 at 10 / 20 / 100; one kernel swapped alone (K1/K2, K3) as all, K4
# 0. So the gap is float32 rounding, not a kernel's fault; the main path
# holds its 20-iteration gap to a bound 3.3x the card-vs-CPU one.
DRIFT_ITERS, DRIFT_RTOL = 20, 1e-2


def lean_stage_trace(scene, iters, device="cuda", parts=None):
    """The loss trace (float64, on the host) of a lean full stage of
    `iters` iterations from the scene's init, check targets, full-stage
    dynamics and no densify, on `device`, with the plain versions of
    `parts` (None: the kernels; on the CPU every call is plain)."""
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg)
    state = init_frame_state(CAPACITY, device)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device=device))
    gen = torch.Generator(device=device).manual_seed(5)
    with contextlib.nullcontext() if parts is None else plain_versions(parts):
        _, _, info = train_stage(params, state, check_targets(img, depth), intr, gen, cfg,
                                 dynamics()[1], device=device)
    return info["loss_trace"].cpu().double()


def drift_check(scene):
    """The DRIFT_ITERS-iteration lean full stage through the kernels and
    through the plain versions (called under deterministic algorithms):
    the largest relative loss gap over the trace within DRIFT_RTOL."""
    kern = lean_stage_trace(scene, DRIFT_ITERS)
    plain = lean_stage_trace(scene, DRIFT_ITERS, parts=PLAIN_PARTS)
    rel = float(((kern - plain).abs() / plain.abs()).max())
    log(f"# {DRIFT_ITERS}-iteration full stage, kernels vs plain versions: max rel loss gap "
        f"{rel:.3e} (bound {DRIFT_RTOL}: scripts/torch_stage_spread.py's card-vs-CPU "
        f"yardstick 3.0e-3 at 20 iterations, x3.3)")
    assert rel <= DRIFT_RTOL, (rel, DRIFT_RTOL)
    return rel


def main_path(scene):
    """The correctness checks, under deterministic algorithms: the
    first-iteration gradients, the 3-stage check and a render of its
    parameters against the plain versions (its graphed run counted as the
    "main path"), the drift and the stamped stage. Returns the graphed
    3-stage check's loss traces, n_alive and parameters."""
    from gflow_tpu_torch.ops import _build

    with deterministic():
        grad_check(scene)
        with plain_versions():
            plain_traces, plain_alive, _, _ = check_run(scene)
        _build.REPLAYED.clear()
        with counted("main path"):
            traces, alive, p, out = check_run(scene)
        launches, replayed = LAUNCHES_BY_PATH["main path"], dict(_build.REPLAYED)
        log(f"# main path launches: {launches}, of them in CUDA graph replays {replayed}")
        for name in (*FIT_KERNELS, "ssim_fwd", "ssim_bwd"):
            assert launches.get(name, 0) > 0, f"kernel {name} never launched on the main path"
            assert replayed.get(name, 0) > 0, f"kernel {name} never launched in a graph replay"

        # both densify events saturate max_densify=256 (occ: 50,000 x
        # 9,216/409,920 x 0.5 = 562 points; error: > 0.5% of pixels above
        # 1e-2 at this stage)
        n0 = scene[4]
        assert alive == [n0, n0 + 512, n0 + 512], alive
        assert alive == plain_alive, (alive, plain_alive)
        for tr in traces:
            assert torch.isfinite(tr).all()
        assert float(traces[1][-1]) < float(traces[1][0]), traces[1]
        # a sanity bound (grad_check holds the gradients tightly): kernel and
        # plain sums differ in order (~1e-6 rel); Adam turns such differences
        # into lr-sized steps where |g| ~ 0, most visibly on the 7 pose
        # parameters of the camera-only stage, so over 10 iterations per
        # stage the loss is held to 1e-2 relative (deterministic, so the
        # same number on every run)
        rel = [float(((tr - ptr).abs() / ptr.abs()).max())
               for tr, ptr in zip(traces, plain_traces)]
        for tr, ptr in zip(traces, plain_traces):
            torch.testing.assert_close(tr, ptr, rtol=1e-2, atol=1e-5)
        log(f"# loss trajectory matches plain path (rtol 1e-2; max rel diff per stage "
            f"{rel}): cam {traces[0][0]:.5f}->{traces[0][-1]:.5f} full {traces[1][0]:.5f}->"
            f"{traces[1][-1]:.5f} cam2 {traces[2][0]:.5f}->{traces[2][-1]:.5f}")
        # the same parameters rendered through kernels and plain versions
        # agree to the compositor tolerance
        with plain_versions():
            plain_out = render_all(scene, p, alive[-1])
        for k in out:
            torch.testing.assert_close(out[k], plain_out[k], atol=5e-4, rtol=1e-3)
        log(f"# render {sorted(out)} matches plain path (atol 5e-4, rtol 1e-3)")
        drift_check(scene)
        stamp_hold(scene)
    return traces, alive, p


def stamp_hold(scene, iters=20):
    """A full stage at the main path's width and capacity (20 iterations,
    an occ densify at 0 and an error densify after iteration 9) with
    stamps (what a trainer with telemetry runs: fit_video's) and without,
    as CUDA graphs, from the same inputs (called under deterministic
    algorithms): the loss traces and parameters 0 apart, the stamp kernel
    launched 5 times an iteration and every other kernel as often as
    without, and every piece of every iteration positive on the card's
    timer (tests/test_torch_cuda.py holds the same at 96x64)."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.ops.stamp import COLS, pieces
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = check_targets(img, depth)
    runs = {}
    for stamps in (True, False):
        cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg, densify_occ=True,
                          densify_interval=10, densify_times=1, max_densify=256,
                          stamps=stamps)
        state = init_frame_state(CAPACITY)._replace(
            n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        _build.LAUNCHES.clear()
        p, _, info = train_stage(params, state, tg, intr, gen, cfg, dynamics()[1])
        torch.cuda.synchronize()
        runs[stamps] = (p, info, dict(_build.LAUNCHES))
    (p, info, launches), (p0, info0, launches0) = runs[True], runs[False]
    table = info["stamps"].cpu().numpy()
    diff = max(float((info["loss_trace"] - info0["loss_trace"]).abs().max()),
               max(float((getattr(p, k) - getattr(p0, k)).abs().max()) for k in p._fields))
    got = pieces(table)
    log(f"# stamped full stage ({iters} iterations, densify) vs unstamped, CUDA graphs "
        f"(deterministic): max abs diff {diff}; launches {launches}, unstamped {launches0}; "
        f"n_alive {int(info['n_alive'])}")
    assert table.shape == (iters, COLS) and "stamps" not in info0
    assert diff == 0 and int(info["n_alive"]) == int(info0["n_alive"]), diff
    stamped = dict(launches)
    assert stamped.pop("stamp", 0) == COLS * iters and stamped == launches0, (launches,
                                                                             launches0)
    assert (np.diff(table, axis=1) > 0).all() and (table[1:, 0] >= table[:-1, -1]).all(), table
    assert all(v > 0 for v in got.values()), got


def canonical_frame(scene):
    """One frame at the canonical budget (bench.py's: 150 camera + 300 full
    iterations, occ densify at 0 and error densify every 100 x2) as CUDA
    graphs, its stages' launches counted as "frame camera" and "frame
    full"."""
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)  # bench.py: all-false move and occ masks
    dyn_cam, dyn_full = dynamics()
    cfg_cam = StageConfig(W=W, H=H, iterations=150, camera_only=True, render=rcfg)
    cfg_full = StageConfig(W=W, H=H, iterations=300, render=rcfg, densify_occ=True,
                           densify_interval=100, densify_times=2,
                           max_densify=min(CAPACITY, 16384))
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    with counted("frame camera"):
        p, s, _ = train_stage(params, s, tg, intr, gen, cfg_cam, dyn_cam)
    with counted("frame full"):
        p, s, info = train_stage(p, s, tg, intr, gen, cfg_full, dyn_full)
    assert torch.isfinite(info["loss_trace"]).all()
    log(f"# canonical frame launches: camera {LAUNCHES_BY_PATH['frame camera']}, full "
        f"{LAUNCHES_BY_PATH['frame full']}; n_alive {int(info['n_alive'])}")


# ---------------------------------------------------------------------------
# the tile bands at full size
# ---------------------------------------------------------------------------

N_BANDS = 4
# banded against unbanded check_run, both deterministic: a band composites
# its tiles in place (row0) with the same kernels, so the two runs do the
# same arithmetic (0 apart on NVIDIA H100 80GB HBM3 cards at 700 W); held
# to float32 noise
BAND_LOSS_RTOL = 1e-6
BAND_PARAM_ATOL = 1e-6


def padded_block(rec, D):
    """rec's packed block, upstream gradient and counts padded with empty
    tiles to whole bands of tile rows; returns them and the rows per band."""
    attrs, counts, g = rec["attrs"], rec["counts"], rec["g"]
    n_ty = attrs.shape[0] // rec["n_tx"]
    pad = (-(-n_ty // D) * D - n_ty) * rec["n_tx"]
    return (torch.cat([attrs, attrs.new_zeros(pad, *attrs.shape[1:])]),
            torch.cat([counts, counts.new_zeros(pad)]),
            torch.cat([g, g.new_zeros(pad, *g.shape[1:])]), -(-n_ty // D) * D // D)


def band_hold(rec, bands):
    """The band compositor on one packed input of the main path (K1 or K2
    forward, K3 backward, one band per entry of `bands`, each kernel
    launched once a band): each band's call against the plain band version
    (hold_renders), and the whole against the unbanded kernel call on the
    same input (hold_composite; gradients normalized by max |ref| per
    column, 5e-4, as bwd_row). Returns the errors."""
    from gflow_tpu_torch.ops import _build, cuda_raster

    attrs_p, counts_p, g_p, rows_per = padded_block(rec, len(bands))
    T, cov, bg, n_tx = rec["attrs"].shape[0], rec["with_cov"], rec["bg"], rec["n_tx"]

    def banded():
        a = attrs_p.detach().requires_grad_()
        res = cuda_raster.band_composite(a, counts_p, bg, n_tx, rows_per, bands, cov)
        out = res[0] if cov else res
        return {"out": out.detach(), "cov": res[1] if cov else None,
                "grad": torch.autograd.grad(out, a, g_p)[0]}

    a = rec["attrs"].detach().requires_grad_()
    res = cuda_raster.packed_composite(a, rec["counts"], bg, n_tx, cov)
    ref = {"out": (res[0] if cov else res).detach(), "cov": res[1] if cov else None,
           "grad": torch.autograd.grad(res[0] if cov else res, a, rec["g"])[0]}
    before = dict(_build.LAUNCHES)
    got = banded()
    torch.cuda.synchronize()
    fwd = "composite_fwd_cov" if cov else "composite_fwd"
    delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    assert delta.get(fwd) == len(bands) and delta.get("composite_bwd") == len(bands), delta
    phase = f"{len(bands)} bands"
    _, plain, calls, steps = hold_renders(banded, atol=5e-4, rtol=1e-3, phase=phase)
    assert len(calls) == len(bands), len(calls)

    def grad_err(g_, w_):
        scale = w_.abs().amax(dim=(0, 1)).clamp_min(1e-12)
        return float(((g_ - w_) / scale).abs().max())

    plain_grad_err = grad_err(got["grad"], plain["grad"])
    out_err, whole_steps = hold_composite(got["out"][:T], ref["out"], rec, 5e-4, 1e-3,
                                          phase=phase, view="banded vs unbanded")
    whole_grad_err = grad_err(got["grad"][:T], ref["grad"])
    assert plain_grad_err <= 5e-4 and whole_grad_err <= 5e-4, (plain_grad_err, whole_grad_err)
    assert not got["grad"][T:].any(), "padding tiles got a gradient"
    if cov:
        torch.testing.assert_close(got["cov"][:T], ref["cov"], atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(got["cov"], plain["cov"], atol=5e-4, rtol=1e-3)
    return {"rows_per_band": rows_per, "out_err_vs_unbanded": out_err,
            "grad_err_vs_unbanded": whole_grad_err, "grad_err_vs_plain": plain_grad_err,
            "steps_per_band": steps, "steps_vs_unbanded": whole_steps}


def banded_scene(scene, bands):
    """scene with its RenderConfig as RenderConfig.for_scene gives it under
    use_mesh(fitting_mesh(device=bands))."""
    import dataclasses

    from gflow_tpu_torch.ops.render import RenderConfig
    from gflow_tpu_torch.parallel.mesh import fitting_mesh, use_mesh

    img, rcfg = scene[0], scene[5]
    with use_mesh(fitting_mesh(device=bands)):
        rc = RenderConfig.for_scene(W, H, N_POINTS, image=img)
    assert rc == dataclasses.replace(rcfg, band_devices=tuple(bands)), rc
    return (*scene[:5], rc)


def banded_phase(scene, inputs, unbanded):
    """The tile-band fitting mode at full size, N_BANDS bands over the
    visible cards (card_list: all on cuda:0 with one card): the band
    compositor on each stage's packed input of the main path at K = 96
    (band_hold), then the 3-stage check (camera 10, full 10 with its two
    densifies, camera 10; 30 tile rows in 4 bands) as CUDA graphs, its
    launches counted as "banded stages", against the main path's unbanded
    run (`unbanded`: its loss traces, n_alive and parameters), both
    deterministic: within BAND_LOSS_RTOL / BAND_PARAM_ATOL, every fit
    kernel launched and a step graph replayed each iteration."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    bands = card_list(N_BANDS)
    for stage, rec in inputs[96].items():
        log(f"# band compositor, main path {stage} stage input (K=96, {N_BANDS} bands on "
            f"{[str(d) for d in bands]}): {json.dumps(band_hold(rec, bands))}")
    traces_u, alive_u, p_u = unbanded
    sb = banded_scene(scene, bands)
    stage_graphs.REPLAYS.clear()
    with deterministic(), counted("banded stages"):
        traces_b, alive_b, p_b, out_b = check_run(sb)
    launches, replays = LAUNCHES_BY_PATH["banded stages"], dict(stage_graphs.REPLAYS)
    for name in FIT_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched in the banded stages"
    assert replays.get("step") == 30, replays  # 3 stages x 10 iterations
    assert alive_b == alive_u, (alive_b, alive_u)
    rel = [float(((b - u).abs() / u.abs()).max()) for b, u in zip(traces_b, traces_u)]
    for b, u in zip(traces_b, traces_u):
        torch.testing.assert_close(b, u, rtol=BAND_LOSS_RTOL, atol=1e-5)
    pdiff = {k: float((getattr(p_b, k) - getattr(p_u, k)).abs().max()) for k in p_u._fields}
    assert max(pdiff.values()) <= BAND_PARAM_ATOL, pdiff
    assert all(torch.isfinite(v).all() for v in out_b.values())
    log(f"# banded stages ({N_BANDS} bands) as CUDA graphs: launches {launches}, graph replays "
        f"{replays}; n_alive {alive_b} (= unbanded); loss traces vs unbanded max rel diff per "
        f"stage {rel} (rtol {BAND_LOSS_RTOL}); params max abs diff {json.dumps(pdiff)} (tol "
        f"{BAND_PARAM_ATOL})")


# ---------------------------------------------------------------------------
# fit_video
# ---------------------------------------------------------------------------

FIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs", "chip_smoke")
# where a failing hold_composite saves its compositor call
HOLD_FAILURES = os.path.join(FIT_DIR, "hold_failures")
# the npz schema of gflow_tpu/pipeline/trainer.py:886-916 (key -> dtype)
CKPT_SCHEMA = {"xyz": "float32", "scale": "float32", "rotate": "float32",
               "opacity": "float32", "rgb": "float32", "intr": "float32", "extr": "float32",
               "still_mask": "bool", "last_uv": "float32", "move_seg": "uint8",
               "width": "int64", "height": "int64"}
# depth cut from the canonical 150 camera + 300 full iterations per frame
FIT = dict(num_points=N_POINTS, iterations_first=100, iterations_camera=30,
           iterations_after=60, camera_first=True, traj_num=16, lr=0.01, lr_camera=0.0,
           lr_after=5e-3, lr_camera_after=1e-4, lambda_rgb=1.0, lambda_depth=0.1,
           lambda_var=50.0, lambda_flow=0.01, lambda_still=1.0, densify_interval=50,
           densify_times=1, densify_interval_after=30, densify_times_after=1)
# PSNR (dB) of the final frame's render against its target: the same fit of
# the same sequence scaled to 192x108 with 2,529 points (N_POINTS x the area
# ratio) gave 34.85 dB on the CPU (scripts/torch_fit_video_floor.py); the
# floor leaves room for the other scale
PSNR_FLOOR = 28.0


def synth_geometry(W, H):
    """tests/synth.py's layout scaled off its 96x64 baseline by W, as there:
    square size, initial corner, px/frame motion and focal length."""
    sx = W / 96.0
    return (max(4, int(round(14 * sx))), int(20 * sx), int(24 * H / 64.0),
            max(1, int(round(6 * sx))), 80.0 * sx)


def write_sequence(root, n_frames=4, W=W, H=H, seed=0):
    """tests/synth.py's static-camera sequence (a textured background, a
    moving square, depth, camera jsons, .flo flows, occ PNGs, epipolar move
    masks, tracking.pkl) in the layout fit_video reads, through the port's
    own writers; the frames are JPEGs, as gflow_tpu/pipeline/split_tapvid.py
    writes a TAP-Vid sequence."""
    import pickle
    from pathlib import Path

    from gflow_tpu_torch.core.io import imwrite, write_camera, write_flow

    rng = np.random.default_rng(seed)
    seq = Path(root) / "synth" / "synth"
    seq.mkdir(parents=True)
    for sfx in ("_depth_mast3r_s2", "_camera_mast3r_s2", "_flow_unimatch", "_epipolar"):
        Path(str(seq) + sfx).mkdir()
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    bg = np.stack([xx, yy, 0.4 + 0.2 * np.sin(7 * xx) * np.cos(5 * yy)], -1)
    bg = np.clip(bg + rng.normal(0, 0.02, bg.shape), 0, 1).astype(np.float32)
    sq, x0, y0, vx, focal = synth_geometry(W, H)
    Z_BG, Z_SQ = 2.0, 1.5
    for t in range(n_frames):
        cx, name = x0 + vx * t, f"{t:05d}"
        img, depth = bg.copy(), np.full((H, W), Z_BG, np.float32)
        img[y0:y0 + sq, cx:cx + sq] = [0.9, 0.2, 0.1]
        depth[y0:y0 + sq, cx:cx + sq] = Z_SQ
        in_sq = np.zeros((H, W), bool)
        in_sq[y0:y0 + sq, cx:cx + sq] = True
        imwrite(seq / f"{name}.jpg", (np.clip(img, 0, 1) * 255).astype(np.uint8))
        np.save(str(seq) + f"_depth_mast3r_s2/{name}.npy", depth)
        write_camera(str(seq) + f"_camera_mast3r_s2/{name}.json", focal, np.eye(4),
                     (W / 2, H / 2))
        imwrite(str(seq) + f"_epipolar/{name}_open.png", (in_sq * 255).astype(np.uint8))
        if t < n_frames - 1:
            flow = np.zeros((H, W, 2), np.float32)
            flow[y0:y0 + sq, cx:cx + sq, 0] = vx
            write_flow(str(seq) + f"_flow_unimatch/{name}_pred.flo", flow)
            imwrite(str(seq) + f"_flow_unimatch/{name}_occ_bwd.png",
                    np.zeros((H, W), np.uint8))
    # TAP-Vid-style tracks: a 3x3 grid on the square, a background grid off
    # its sweep corridor (static camera: a point moves only with the square)
    qs = [(x0 + fx * sq, y0 + fy * sq, True) for fy in (0.25, 0.5, 0.75)
          for fx in (0.25, 0.5, 0.75)]
    for by in (0.15, 0.5, 0.85):
        for bx in (0.1, 0.5, 0.9):
            py = by * H
            if y0 - 8 <= py <= y0 + sq + 8:
                py = y0 - 20 if y0 > 30 else y0 + sq + 20
            qs.append((bx * W, py, False))
    pts = np.asarray([[((qx + vx * t * on_sq) / W, qy / H) for t in range(n_frames)]
                      for qx, qy, on_sq in qs], np.float64)
    with open(seq / "tracking.pkl", "wb") as f:
        pickle.dump({"points": pts, "occluded": np.zeros(pts.shape[:2], bool)}, f)
    return seq


def host_libraries():
    """What the fit_video path uses for image and video files here: PIL for
    images, imageio's mp4 where it has an encoder, else PIL's MJPEG AVI."""
    from gflow_tpu_torch.viz.video import _mp4_available

    def importable(name):
        try:
            __import__(name)
        except ImportError:
            return False
        return True

    return {"PIL": importable("PIL"), "imageio": importable("imageio"),
            "matplotlib": importable("matplotlib"),
            "videos": "imageio mp4" if _mp4_available() else "MJPEG AVI"}


def run_fit_video(root, device, **overrides):
    """Write the sequence under `root` and run the port's fit_video on it;
    returns (trainer, sequence path, wall seconds)."""
    from gflow_tpu_torch.pipeline.fit_video import main as fit_video

    kw = dict(FIT, **overrides)
    W_, H_ = kw.pop("W", W), kw.pop("H", H)
    seq = write_sequence(root, W=W_, H=H_)
    t0 = time.perf_counter()
    trainer = fit_video(sequence_path=seq, logs_suffix=os.path.join(str(root), "logs"),
                        device=device, **kw)
    return trainer, seq, time.perf_counter() - t0


def fit_video_outputs(trainer, W_=W, H_=H):
    """The log directory holds what tests/test_fit_video.py:44-59 checks, 3
    checkpoints of the JAX package's schema, a final render above
    PSNR_FLOOR and a move segmentation that fills the square's last
    position. Returns (psnr, segmentation fill)."""
    import pickle

    d = trainer.dir
    imgs = os.listdir(os.path.join(d, "images"))
    assert any(f.startswith("img_00000") for f in imgs) and any(
        f.startswith("img_00002") for f in imgs), imgs
    ckpts = sorted(os.listdir(os.path.join(d, "ckpt")))
    assert len(ckpts) == 3, ckpts
    for c in ckpts:
        z = np.load(os.path.join(d, "ckpt", c))
        got = {k: str(z[k].dtype) for k in z.files}
        assert got == CKPT_SCHEMA, (c, got)
    for name in ("sequence", "sequence_optimize", "training_rgb", "sequence_traj"):
        assert any(os.path.exists(os.path.join(d, name + ext)) for ext in (".mp4", ".avi")), name
    with open(os.path.join(d, "sequence_traj.pkl"), "rb") as f:
        traj = pickle.load(f)
    assert len(traj) == 3 and traj[0].ndim == 2
    final = trainer.render_views(("rgb",))["rgb"].cpu().numpy()
    psnr = float(-10 * np.log10(np.mean((final - trainer.gt_image) ** 2)))
    sq, x0, y0, vx, _ = synth_geometry(W_, H_)
    m, cx = max(2, sq // 7), x0 + 2 * vx  # the square at frame 2, inset by 1/7 of its side
    fill = float(trainer.move_seg[y0 + m:y0 + sq - m, cx + m:cx + sq - m].mean())
    return psnr, fill


@contextmanager
def compositor_shapes():
    """Count the forward compositor launches by shape (K1/K2 by K and F)
    while the block runs, eager or replayed in a CUDA graph (a launch hook:
    nothing is patched, so the stages' graphs are the main path's own)."""
    import collections

    from gflow_tpu_torch.ops import _build

    counts = collections.Counter()

    def tally(name, args):
        if name in ("composite_fwd", "composite_fwd_cov"):
            T, K, CA = args[1]  # g_attrs' shape
            cov = name == "composite_fwd_cov"
            counts[f"{'K2' if cov else 'K1'} K={K} F={CA - 6 - int(cov)}"] += 1

    _build.LAUNCH_HOOKS.append(tally)
    try:
        yield counts
    finally:
        _build.LAUNCH_HOOKS.remove(tally)


def fit_video_phase():
    """The port's fit_video at 854x480 / 50,000 points on the card (depth
    cut: FIT), its launches counted as "fit_video"; then the final
    checkpoint rendered (render_scene) and the trajectory line set drawn
    through the kernels and through the plain versions, and the checkpoint
    loaded into a trainer."""
    import shutil

    from gflow_tpu_torch.ops.render import render_scene
    from gflow_tpu_torch.ops.stamp import COLS
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer
    from gflow_tpu_torch.utils.hull import native_loaded

    shutil.rmtree(FIT_DIR, ignore_errors=True)
    log(f"# fit_video: host libraries {json.dumps(host_libraries())}; native hull library "
        f"loaded: {native_loaded()}")
    with counted("fit_video"), compositor_shapes() as shapes:
        trainer, seq, _ = run_fit_video(FIT_DIR, "cuda")
    launches = LAUNCHES_BY_PATH["fit_video"]
    log(f"# fit_video launches: {launches}; packed compositor calls by shape: "
        f"{json.dumps(dict(sorted(shapes.items())))}")
    for name in FIT_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched in fit_video"
    rc = trainer.render_config
    log(f"# fit_video RenderConfig: M={rc.max_tiles_per_gaussian} K={rc.max_per_tile} "
        f"small={rc.small_tiles_per_gaussian}; capacity {trainer.capacity}; K escalations "
        f"{json.dumps(trainer.k_escalations)}; n_alive {trainer.current_pts_num()}")
    assert trainer.capacity == 75_776, trainer.capacity
    psnr, fill = fit_video_outputs(trainer)
    log(f"# fit_video final frame PSNR {psnr:.3f} dB (floor {PSNR_FLOOR}); move "
        f"segmentation fill of the square {fill:.1f} / 255 (floor 50)")
    assert psnr > PSNR_FLOOR and fill > 50, (psnr, fill)
    # the trainer has telemetry, so every stage stamped its iterations; the
    # loss's SSIM: the backward kernel once an iteration, the forward's
    # other launches the no-grad forwards (error densify, a stage's output)
    iters = trainer.telemetry.summary()["phases"]["iter/render"]["calls"]
    log(f"# fit_video over {iters} iterations: stamp {launches.get('stamp')}, ssim_fwd "
        f"{launches.get('ssim_fwd')}, ssim_bwd {launches.get('ssim_bwd')} launches")
    assert launches.get("stamp") == COLS * iters, (launches.get("stamp"), iters)
    assert launches.get("ssim_bwd") == iters and launches.get("ssim_fwd", 0) > iters, launches

    # the final checkpoint, as a saved scene, through the kernels and through
    # the plain versions; then loaded into a trainer, which renders the same
    ckpt = os.path.join(trainer.dir, "ckpt", sorted(os.listdir(
        os.path.join(trainer.dir, "ckpt")))[-1])
    saved, camera = checkpoint_scene(ckpt)
    outs = ("rgb", "depth_map", "acc", "center")
    traj_args = (len(trainer._traj["last_rgb"]), 0.5, 2.0)

    def draw():
        out = render_scene(saved, camera, trainer.bg, W, H, outs, rc)
        return {**out, "traj": trainer.traj_image(*traj_args)}

    # the fit differs from call to call (index_add_'s atomics), so a slot on
    # one of alpha's steps is met now and then: hold_renders accounts for it
    got, want, _, steps = hold_renders(draw, atol=5e-4, rtol=1e-3, phase="fit_video")
    errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert float(got["traj"].max()) > 0.1, "the trajectory overlay is empty"
    shell = GFlowTrainer(trainer.gt_image, num_points=N_POINTS, make_logs=False,
                         render_config=rc)
    shell.load_checkpoint(ckpt)
    views = shell.render_views(outs)
    shell_err = {}
    for k in outs:
        torch.testing.assert_close(views[k], got[k], atol=5e-4, rtol=1e-3)
        shell_err[k] = float((views[k] - got[k]).abs().max())
    log(f"# fit_video final checkpoint ({saved.n_alive} points, "
        f"{len(trainer._traj['xyz'])} trajectory entries) through kernels vs plain versions "
        f"(each compositor call: atol 5e-4, rtol 1e-3 but where alpha's steps or float32 "
        f"rounding explain it), max abs err: {json.dumps(errs)}, pixels past the tolerance "
        f"so explained per call {steps}; the checkpoint loaded into a trainer renders the "
        f"same (max abs err {json.dumps(shell_err)})")
    return {"log_dir": trainer.dir, "sequence": str(seq), "render_config": rc}


def checkpoint_scene(path):
    """A saved checkpoint (its raw live rows, intrinsics and pose) as a
    core.scene.GaussianScene and a core.camera.Camera on the card."""
    from gflow_tpu_torch.core.camera import Camera
    from gflow_tpu_torch.core.scene import GaussianScene

    z = np.load(path)
    t = lambda k: torch.from_numpy(z[k]).cuda()
    scene = GaussianScene(t("xyz"), t("scale"), t("rotate"), t("opacity"), t("rgb"),
                          n_alive=int(z["xyz"].shape[0]))
    camera = Camera(intr=t("intr"), pose=torch.zeros(7, device="cuda")).with_extr(z["extr"])
    return scene, camera


# ---------------------------------------------------------------------------
# eval and viewer: what a user does with the fit
# ---------------------------------------------------------------------------


def lpips_weights_file(path):
    """Seeded random LPIPS(Alex) weights (no real weights ship with the repo
    and none are downloaded), under the released torch key names, through
    the port's converter into `path`."""
    from gflow_tpu_torch.eval import lpips_convert

    rng = np.random.default_rng(7)
    sd = {k: rng.normal(0, 0.05, s).astype(np.float32)
          for k, s in lpips_convert.expected_torch_keys().items()}
    sd = {k: np.abs(v) if k.endswith(".bias") else v for k, v in sd.items()}
    lpips_convert.save_npz(lpips_convert.convert(merged_sd=sd), path)
    return path


def eval_phase(fit):
    """The port's benchmark (eval.benchmark.main, the four suites) on
    fit_video's log directory and sequence, on the card (its launches
    counted as "eval"), then again on the plain versions. Holds PSNR, J, F,
    ATE and RPE identical, OA / AJ / APTS identical or within one
    query-frame's share, and SSIM and LPIPS within 1e-5 relative of the
    same suite on the CPU. Returns the packed compositor input and sorted
    stream of the first tracking render."""
    import pickle

    from gflow_tpu_torch.core.io import load_image
    from gflow_tpu_torch.eval import benchmark
    from gflow_tpu_torch.eval.metrics import LPIPS_WEIGHTS_ENV
    from gflow_tpu_torch.ops.render import RenderConfig
    from gflow_tpu_torch.opt import graphs as stage_graphs

    log_dir, seq = fit["log_dir"], fit["sequence"]
    os.environ[LPIPS_WEIGHTS_ENV] = lpips_weights_file(os.path.join(FIT_DIR, "lpips_alex.npz"))
    # the tracking suite's trainer picks this config from frame 0 at 1000 points
    rc = RenderConfig.for_scene(W, H, 1000, image=load_image(os.path.join(seq, "00000.jpg")))
    log(f"# eval RenderConfig (for_scene at 1000 points): M={rc.max_tiles_per_gaussian} "
        f"K={rc.max_per_tile} small={rc.small_tiles_per_gaussian} "
        f"({'two-class' if rc.small_tiles_per_gaussian else 'single-class'} binning)")
    assert rc.small_tiles_per_gaussian > 0 and rc.max_per_tile == 128, rc

    stage_graphs.REPLAYS.clear()
    with counted("eval"), compositor_shapes() as shapes:
        got = benchmark.main(log_dir, seq, csv_name="chip_smoke", device="cuda")
    launches, replays = LAUNCHES_BY_PATH["eval"], dict(stage_graphs.REPLAYS)
    # one tracking render and one projection per checkpoint, all replays
    assert replays.get("render") == 3 and replays.get("world2pix") == 3, replays
    # the compositor's and the binning's inputs, recorded as the calls run
    with stage_graphs.disable_graphs(), capture_packed() as packed, \
            capture_binning() as binned:
        benchmark.eval_tracking(seq, log_dir, device="cuda")
    with stage_graphs.disable_graphs(), plain_versions():
        want = benchmark.main(log_dir, seq, csv_name="chip_smoke_plain", device="cuda")
    cpu = benchmark.eval_reconstruction(log_dir, seq, device="cpu")
    log(f"# eval kernels: {json.dumps(got)}")
    log(f"# eval plain versions: {json.dumps(want)}")
    log(f"# eval reconstruction on the CPU: {json.dumps(cpu)}")
    log(f"# eval launches: {launches}; graph replays {json.dumps(replays)}; packed "
        f"compositor calls by shape: {json.dumps(dict(sorted(shapes.items())))}")
    assert launches.get("composite_fwd", 0) > 0 and launches.get("bin_tail", 0) > 0, launches
    assert dict(shapes) == {"K1 K=128 F=2": 3}, shapes  # one per checkpoint

    # one query-frame of the strided evaluation: Q queries over the T
    # checkpoints, each scored on the T - 1 frames other than its query's
    with open(os.path.join(seq, "tracking.pkl"), "rb") as f:
        Q = pickle.load(f)["points"].shape[0]
    T = len(os.listdir(os.path.join(log_dir, "ckpt")))
    share = 100.0 / (Q * (T - 1))
    for k in ("PSNR", "J_zero", "F_zero", "J&F_zero", "ATE", "RPE_t", "RPE_r"):
        assert got[k] is not None and got[k] == want[k], (k, got[k], want[k])
    track = {}
    for k in ("Occlusion_Accuracy", "Average_Jaccard", "Average_PTS_within_threshold"):
        track[k] = abs(got[k] - want[k])
        assert track[k] <= share, (k, got[k], want[k], share)
    rel = {k: abs(got[k] - cpu[k]) / abs(cpu[k]) for k in ("SSIM", "LPIPS")}
    assert all(v <= 1e-5 for v in rel.values()), rel
    assert 20 < got["PSNR"] and got["LPIPS"] is not None
    log(f"# eval holds: PSNR, J, F, ATE, RPE identical to the plain run; |OA/AJ/APTS - plain| "
        f"{json.dumps(track)} (bound: one query-frame, {share:.3f}); SSIM and LPIPS vs CPU, "
        f"relative {json.dumps(rel)} (tol 1e-5)")
    return packed[0], binned["streams"][0]


def viewer_views(n):
    """The viewer phase's views of n frames: name -> (frame, view kwargs):
    every frame in follow mode, one orbit and one free 6-DoF pose."""
    follow = dict(az=0.0, el=0.0, radius=0.0, follow=True)
    views = {f"follow {i}": (i, follow) for i in range(n)}
    views["orbit"] = (n - 1, dict(az=0.35, el=-0.15, radius=0.25, follow=False))
    views["free"] = (0, dict(az=0.0, el=0.0, radius=0.0, follow=False,
                             pose=[0.995, 0.03, -0.08, 0.02, 0.05, -0.03, -0.1]))
    return views


def viewer_hold(state, views):
    """Each view's rgb (ViewerState.render_rgb, eager) through the kernels
    and through the plain versions, held to 1e-5 but where alpha's steps
    or float32 rounding explain it (hold_composite, phase "viewer").
    Returns the packed compositor call of each view, the max abs errors
    and the pixels past the tolerance."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    with stage_graphs.disable_graphs(), capture_packed() as packed:
        got = {k: state.render_rgb(i, **kw) for k, (i, kw) in views.items()}
    with stage_graphs.disable_graphs(), plain_versions():
        want = {k: state.render_rgb(i, **kw) for k, (i, kw) in views.items()}
    assert len(packed) == len(views), len(packed)  # one compositor call per render
    errs, steps = {}, {}
    for k, rec in zip(views, packed):
        assert got[k].shape == (H, W, 3) and float(got[k].std()) > 0.02, k
        errs[k], steps[k] = hold_composite(image_tiles(got[k], rec["n_tx"]),
                                           image_tiles(want[k], rec["n_tx"]), rec,
                                           atol=1e-5, rtol=0, phase="viewer", view=k)
    return packed, errs, steps


def viewer_phase(fit):
    """The port's viewer on fit_video's log directory: ViewerState on the
    card; every frame in follow mode, one orbit and one free 6-DoF pose,
    each rgb (before JPEG) held against the plain versions to 1e-5 but
    where alpha's steps or float32 rounding explain it (viewer_hold); then
    make_handler served on 127.0.0.1:0 in a thread, with /info and one
    /render checked. The launches from the first render to the HTTP round
    trip are counted as "viewer". Returns the packed compositor input of
    the first render."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.viz.viewer import ViewerState, make_handler

    state = ViewerState(fit["log_dir"], device="cuda")
    n = len(state.frames)
    stage_graphs.REPLAYS.clear()
    with counted("viewer"):
        with compositor_shapes() as shapes:
            packed, errs, steps = viewer_hold(state, viewer_views(n))
        log(f"# viewer: {n} frames, {state.n_points} points; rgb through kernels vs plain "
            f"versions (atol 1e-5 but where alpha's steps or float32 rounding explain it), max "
            f"abs err: {json.dumps(errs)}; pixels past the tolerance so explained: "
            f"{json.dumps(steps)}")
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/info", timeout=60) as r:
                info = json.loads(r.read())
            with urllib.request.urlopen(base + "/render?frame=1&follow=0&az=0.3&el=0.1&r=0.2",
                                        timeout=60) as r:
                ctype, body = r.headers["Content-Type"], r.read()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    assert not thread.is_alive()
    launches = LAUNCHES_BY_PATH["viewer"]
    # the HTTP render replayed the viewer's graphs
    assert stage_graphs.REPLAYS.get("render", 0) >= 1, dict(stage_graphs.REPLAYS)
    assert (info["n_frames"], info["n_points"], info["width"], info["height"]) == (
        n, state.n_points, W, H) and len(info["poses"]) == n, info
    assert ctype == "image/jpeg" and Image.open(io.BytesIO(body)).size == (W, H)
    log(f"# viewer HTTP on 127.0.0.1: /info {json.dumps({k: v for k, v in info.items() if k != 'poses'})}, "
        f"/render a {len(body)}-byte JPEG of {W}x{H}; viewer launches {launches}; graph "
        f"replays {json.dumps(dict(stage_graphs.REPLAYS))}; packed compositor calls by shape "
        f"(the checked renders): {json.dumps(dict(shapes))}")
    assert launches.get("composite_fwd", 0) > 0 and launches.get("bin_tail", 0) > 0, launches
    assert set(shapes) == {"K1 K=128 F=3"}, shapes
    return packed[0]


# ---------------------------------------------------------------------------
# prior preparation: prep_flow, prep_moveseg, prep_depth
# ---------------------------------------------------------------------------

PREP_DIR = os.path.join(FIT_DIR, "prep")
# seeded random weights, scaled as the JAX package's replica tests scale
# their torch init (exp / expm1 overflow on unscaled random weights)
GMFLOW_SCALE, MAST3R_SCALE = 0.5, 0.3


MAST3R_SIZE = 288  # prep_depth's inference size: 854x480 runs at 512x288
# a directed GMFlow pair at the released width, on the CPU in seconds:
# /32 (padding_factor) and divisible by the splits at 1/8 (2) and 1/4 (8)
HOLD_FLOW_HW = (192, 320)


OCC_MARGIN = 1e-4   # |diff - bound| under which an occlusion test may flip


MASK_FLIPS = 1e-3   # share of moving-mask pixels that may flip, card vs CPU
# normalized epipolar error map, card vs CPU: the LMedS's refit takes the
# null vector of A^T A summed over 410k float32 rows, which the two sides
# sum in another order (5.3e-3 apart on an H100 80GB HBM3 at 700 W)
MAP_ATOL = 1e-2


def prep_sequence():
    """write_sequence's 4 frames (854x480 JPEG) with its priors removed:
    the prep stages write them."""
    import shutil

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    seq = write_sequence(PREP_DIR)
    for sfx in ("_depth_mast3r_s2", "_camera_mast3r_s2", "_flow_unimatch", "_epipolar"):
        shutil.rmtree(str(seq) + sfx)
    return str(seq)


def meta_model(cls, cfg, sd, device):
    """`cls(cfg)` holding `sd` on `device`, built without initializing."""
    with torch.device("meta"):
        model = cls(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval()


def hold_occlusion(fwd, bwd):
    """forward_backward_consistency of the same flows on the card and on
    the CPU: equal, but where a pixel's |diff - bound| < OCC_MARGIN (the
    two sides may round it apart). Returns (differing pixels, the card's
    backward occlusion map)."""
    from gflow_tpu_torch.models.unimatch import forward_backward_consistency
    from gflow_tpu_torch.models.unimatch.gmflow import consistency_terms

    f, b = torch.from_numpy(fwd)[None], torch.from_numpy(bwd)[None]
    card = forward_backward_consistency(f.cuda(), b.cuda())
    cpu = forward_backward_consistency(f, b)
    flips = 0
    for (diff, bound), g, w in zip(consistency_terms(f, b), card, cpu):
        differ = g.cpu() != w
        assert bool(((diff - bound).abs() < OCC_MARGIN)[differ].all()), "occlusion differs"
        flips += int(differ.sum())
    return flips, card[1][0].cpu().numpy()


def prep_flow_phase(seq):
    """prep_flow.main through --checkpoint (a released-layout .pth of
    seeded weights at the released width), each directed pair a graph
    replay; the outputs' schema; the occlusion on the card against the CPU;
    one directed pair on the card against the CPU at HOLD_FLOW_HW."""
    from gflow_tpu_torch.core.io import imread, load_image, read_flow
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.pipeline import prep_flow
    from gflow_tpu_torch.utils.cli import run_cli

    sd = seeded_state_dict(convert.expected_torch_keys(), seed=0, scale=GMFLOW_SCALE)
    pth = os.path.join(PREP_DIR, "gmflow_seeded.pth")
    torch.save({"model": sd}, pth)
    run_cli(prep_flow.main, ["--img-dir", seq, "--checkpoint", pth])
    assert stage_graphs.REPLAYS.get("gmflow") == 6, dict(stage_graphs.REPLAYS)
    out = seq + "_flow_unimatch"
    flows, flips, occ_share = {}, 0, []
    for t in range(3):
        fwd, bwd = (read_flow(os.path.join(out, f"{t:05d}_pred{s}.flo")) for s in ("", "_bwd"))
        occ = imread(os.path.join(out, f"{t:05d}_occ_bwd.png"))
        assert fwd.shape == bwd.shape == (H, W, 2) and occ.shape == (H, W), (fwd.shape, occ.shape)
        assert np.isfinite(fwd).all() and np.isfinite(bwd).all()
        n, card_occ = hold_occlusion(fwd, bwd)
        flips += n
        occ_share.append(float(card_occ.mean()))
        assert np.array_equal(occ, (card_occ * 255).astype(np.uint8)), "occlusion PNG"
        flows[t] = fwd

    h, w = HOLD_FLOW_HW
    a, b = (torch.from_numpy(load_image(os.path.join(seq, f"{t:05d}.jpg"))[:h, :w])[None]
            for t in (0, 1))
    cfg = GMFlowConfig()
    with torch.inference_mode():
        want = meta_model(GMFlow, cfg, sd, "cpu")(a, b)
        got = meta_model(GMFlow, cfg, sd, "cuda")(a.cuda(), b.cuda()).cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
    mean_flow = [float(np.abs(f).mean()) for f in flows.values()]
    log(f"# prep_flow: GMFlow {cfg} at 864x480 (854x480 padded), 3 pairs x 2 directions as "
        f"CUDA graphs; mean |flow| {mean_flow}; occluded share {occ_share}; occlusion card vs "
        f"CPU on the same flows: {flips} pixels differ (allowed only where |diff - bound| < "
        f"{OCC_MARGIN}); one directed pair at {w}x{h} card vs CPU max abs err {err:.3e} (atol "
        f"5e-4, rtol 1e-3; |flow| max {float(want.abs().max()):.3f})")
    return flows, sd


def scene_flow(H_, W_, seed=0):
    """Forward flow of a rigid scene (smooth random depth: a unique F)
    under a rotating and translating camera, with a block moving against
    it; and the block's slices."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H_, dtype=np.float64), np.arange(W_, dtype=np.float64),
                         indexing="ij")
    f, a = 0.9 * W_, rng.uniform(1, 3, 4)
    Z = 3 + np.sin(a[0] * xx / W_ * 3 + a[1]) * np.cos(a[2] * yy / H_ * 3 + a[3])
    P = np.stack([(xx - W_ / 2) * Z / f, (yy - H_ / 2) * Z / f, Z], -1)
    th, ph = 0.03, 0.02
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(ph), -np.sin(ph)], [0, np.sin(ph), np.cos(ph)]])
    Q = P @ (Ry @ Rx).T + np.array([0.15, 0.05, 0.1])
    flow = np.stack([f * Q[..., 0] / Q[..., 2] + W_ / 2 - xx,
                     f * Q[..., 1] / Q[..., 2] + H_ / 2 - yy], -1)
    block = (slice(H_ // 3, H_ // 2), slice(W_ // 3, W_ // 2))
    flow[block] = (-6.0, 4.0)
    return flow.astype(np.float32), block


def hold_error_map(flow):
    """epipolar_error_map on the card against the CPU with the same draws.
    Returns (max |card - CPU| of the normalized map, flipped mask share,
    the card's map)."""
    from gflow_tpu_torch.ops.epipolar import lmeds_draws
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map

    draws = lmeds_draws(flow.shape[0] * flow.shape[1])
    got = epipolar_error_map(flow, device="cuda", draws=draws)
    want = epipolar_error_map(flow, device="cpu", draws=draws)
    return float(np.abs(got - want).max()), float(((got > 0.01) != (want > 0.01)).mean()), got


def prep_moveseg_phase(seq, flows):
    """prep_moveseg.main on prep_flow's flows, each frame's LMedS a graph
    replay; its PNGs; epipolar_error_map card vs CPU with the same draws on
    a rigid scene's flow (a unique F: normalized maps within MAP_ATOL, at
    most MASK_FLIPS of the mask flipped), reported on prep_flow's own flows
    (random weights give flows with no epipolar structure, where the
    LMedS's winner is a near-tie); and the translation-parallax flow of
    tests/test_epipolar.py at 854x480: the block's mean error > 10x the
    background's."""
    from gflow_tpu_torch.core.io import imread
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.pipeline import prep_moveseg
    from gflow_tpu_torch.utils.cli import run_cli

    run_cli(prep_moveseg.main, ["--img-dir", seq])
    assert stage_graphs.REPLAYS.get("lmeds") == 3, dict(stage_graphs.REPLAYS)
    moving = []
    for t in range(3):
        for tag in ("epipolar_error", "open", "erode", "dilate"):
            png = imread(os.path.join(seq + "_epipolar", f"{t:05d}_{tag}.png"))
            assert png.shape == (H, W) and png.dtype == np.uint8, (tag, png.shape)
        moving.append(float((imread(os.path.join(seq + "_epipolar", f"{t:05d}_open.png")) > 0)
                            .mean()))

    flow, block = scene_flow(H, W)
    with uncounted():  # card against CPU: comparison launches
        err, flipped, got = hold_error_map(flow)
        prep_err, prep_flipped, _ = hold_error_map(flows[0])
    assert err <= MAP_ATOL and flipped <= MASK_FLIPS, (err, flipped)
    assert (got[block] > 0.01).all() and (got > 0.01).mean() < 0.1

    par = np.zeros((H, W, 2), np.float32)  # the test's flow, its regions scaled to 854x480
    par[..., 0] = 3.0 * np.linspace(0.8, 1.2, H)[:, None]
    ys, xs = slice(H * 30 // 96, H * 60 // 96), slice(W * 40 // 128, W * 80 // 128)
    par[ys, xs] = (-4.0, 2.5)
    with uncounted():
        e = prep_moveseg.epipolar_error_map(par)
    inside = float(e[H * 35 // 96: H * 55 // 96, W * 45 // 128: W * 75 // 128].mean())
    outside = float(np.r_[e[:H * 20 // 96].ravel(), e[H * 70 // 96:].ravel()].mean())
    assert inside > 10 * outside, (inside, outside)
    log(f"# prep_moveseg: the LMedS on the card as a CUDA graph, small_eig's eigenvectors; "
        f"moving share after opening {moving}; error map card vs CPU with the same draws on a "
        f"rigid scene's 854x480 flow: max abs err {err:.3e} (tol {MAP_ATOL}), mask flips "
        f"{flipped:.2e} (tol {MASK_FLIPS}); on prep_flow's first flow (reported, not held): "
        f"max abs err {prep_err:.3e}, mask flips {prep_flipped:.2e}; translation parallax: "
        f"block mean {inside:.4f} vs background {outside:.3e}")


def prep_depth_phase(seq):
    """prep_depth.main with MASt3R catmlp+dpt at the released width
    (seeded weights x MAST3R_SCALE) over the 4 frames: inference size 288
    (the short side, as the JAX module resizes: 512x288, 576 tokens a
    view, the size MASt3R's own loader gives 854x480 at 512), 10 directed
    pairs as graph replays, the full 700-step global_align. The output
    schema; one pair on the card against the CPU; and the --checkpoint
    path with a small released-layout .pth."""
    import shutil

    from gflow_tpu_torch.core.io import _resize_hw, imread, load_image, read_camera
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.pipeline import prep_depth
    from gflow_tpu_torch.utils.cli import run_cli

    cfg = Mast3rConfig(head="catmlp+dpt")
    sd = seeded_state_dict(convert.expected_torch_keys(head="catmlp+dpt"), seed=0,
                           scale=MAST3R_SCALE)
    sd = {k: v for k, v in sd.items() if not k.startswith(convert._IGNORED_PREFIXES)}
    model = meta_model(Mast3rModel, cfg, sd, "cuda")
    n_params = sum(v.numel() for v in sd.values())
    prep_depth.main(seq, inference_size=MAST3R_SIZE, model=model)
    assert stage_graphs.REPLAYS.get("mast3r") == 10, dict(stage_graphs.REPLAYS)

    names = [f"{t:05d}" for t in range(4)]
    inf_hw = _resize_hw((H, W), MAST3R_SIZE)  # (288, 512) at 854x480
    for n in names:
        d = np.load(os.path.join(seq + "_depth_mast3r_s2", f"{n}.npy"))
        png = imread(os.path.join(seq + "_depth_mast3r_s2", f"{n}.png"))
        pts = np.load(os.path.join(seq + "_pts3d_mast3r_s2", f"{n}.npy"))
        assert d.shape == (H, W) and png.shape == (H, W, 3) and pts.shape == inf_hw, (
            d.shape, png.shape, pts.shape)
        assert np.isfinite(d).all() and np.isfinite(pts).all()
    cams = [os.path.join(seq + "_camera_mast3r_s2", f"{n}.json") for n in names]
    focal, pp, extr = read_camera(cams)
    assert np.isfinite(focal) and focal > 0 and pp == [W // 2, H // 2], (focal, pp)
    assert extr.shape == (4, 3, 4) and np.isfinite(extr).all()

    # one pair on the card against the CPU, at full depth
    a, b = (torch.from_numpy(load_image(os.path.join(seq, f"{n}.jpg"), resize=MAST3R_SIZE))[None]
            for n in names[:2])
    assert a.shape[1:3] == inf_hw, a.shape
    with torch.inference_mode(), uncounted():
        got = model(a.cuda(), b.cuda())
        want = meta_model(Mast3rModel, cfg, sd, "cpu")(a, b)
    errs = {}
    for v, (g, w_) in enumerate(zip(got, want), 1):
        for k in w_:
            errs[f"view{v} {k}"] = float((g[k].cpu() - w_[k]).abs().max())
            torch.testing.assert_close(g[k].cpu(), w_[k], atol=1e-3, rtol=1e-3)
    del got

    # --checkpoint: a small released-layout .pth on a 3-frame copy
    small = convert.expected_torch_keys(2, 2, 128, 128, 16, "linear")
    pth = os.path.join(PREP_DIR, "mast3r_small.pth")
    torch.save({"model": seeded_state_dict(small, seed=1, scale=MAST3R_SCALE)}, pth)
    ck_seq = os.path.join(PREP_DIR, "ckpt_seq", "ckpt_seq")
    os.makedirs(ck_seq)
    for n in names[:3]:
        shutil.copy(os.path.join(seq, f"{n}.jpg"), ck_seq)
    run_cli(prep_depth.main, ["--img-dir", ck_seq, "--checkpoint", pth, "--inference-size",
                              str(MAST3R_SIZE)])
    ck_focal, _, ck_extr = read_camera(sorted(
        os.path.join(ck_seq + "_camera_mast3r_s2", f) for f in os.listdir(
            ck_seq + "_camera_mast3r_s2")))
    assert ck_extr.shape == (3, 3, 4) and np.isfinite(ck_extr).all() and np.isfinite(ck_focal)
    log(f"# prep_depth: MASt3R catmlp+dpt ViT-L 1024x24 / ViT-B 768x12, "
        f"{n_params / 1e6:.1f}M parameters (seeded, x{MAST3R_SCALE}), {inf_hw[1]}x{inf_hw[0]} "
        f"({-(-inf_hw[0] // 16) * -(-inf_hw[1] // 16)} tokens a view), 10 pairs as CUDA "
        f"graphs, global_align 700 Adam steps; focal {focal:.2f}; one pair card vs CPU max abs "
        f"err {json.dumps(errs)} (atol 1e-3, rtol 1e-3); --checkpoint (small linear .pth, 3 "
        f"frames) ran")
    return model


def copy_frames(seq, dest, n):
    """The first n frames of seq copied into a new directory dest."""
    import shutil

    os.makedirs(dest)
    for t in range(n):
        shutil.copy(os.path.join(seq, f"{t:05d}.jpg"), dest)
    return dest


@contextmanager
def mesh_over_cards():
    """make_mesh with the mesh's devices over the visible cards, round
    robin (the prep mains ask for n cards, which one card cannot give)."""
    from gflow_tpu_torch.parallel import mesh

    make = mesh.make_mesh
    with mock.patch.object(mesh, "make_mesh", lambda n, data_parallel=None, device=None:
                           make(n, data_parallel, device=list(card_list(n)))):
        yield


def prep_mesh_hold(seq, gmflow_sd, mast3r):
    """prep_flow (GMFlow at the released width, the prep phase's seeded
    weights) on the prep sequence's 4 frames and prep_depth (its MASt3R)
    on 3 of them, each with mesh_devices=2 (replicas over card_list(2):
    both on cuda:0 with one card) against mesh_devices=0: flows within
    2e-4, depth within 2e-3 (tests/test_sharded_infer.py:52, 83)."""
    from gflow_tpu_torch.core.io import read_flow
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow

    root = os.path.join(PREP_DIR, "mesh")
    gmflow = meta_model(GMFlow, GMFlowConfig(), gmflow_sd, "cuda")
    runs = {}
    with mesh_over_cards():
        for m in (0, 2):
            d = copy_frames(seq, os.path.join(root, f"flow{m}", "seq"), 4)
            prep_flow.main(d, model=gmflow, mesh_devices=m)
            runs[("flow", m)] = d + "_flow_unimatch"
            d = copy_frames(seq, os.path.join(root, f"depth{m}", "seq"), 3)
            prep_depth.main(d, model=mast3r, inference_size=MAST3R_SIZE, mesh_devices=m)
            runs[("depth", m)] = d + "_depth_mast3r_s2"
    flow_err = max(float(np.abs(read_flow(os.path.join(runs[("flow", 2)], f)) - read_flow(
        os.path.join(runs[("flow", 0)], f))).max()) for f in sorted(os.listdir(runs[("flow", 0)]))
        if f.endswith(".flo"))
    depth_err = max(float(np.abs(np.load(os.path.join(runs[("depth", 2)], f)) - np.load(
        os.path.join(runs[("depth", 0)], f))).max()) for f in sorted(os.listdir(
            runs[("depth", 0)])) if f.endswith(".npy"))
    log(f"# prep mesh_devices=2 vs 0 over {[str(d) for d in card_list(2)]}: flows max abs diff "
        f"{flow_err:.3e} (tol 2e-4), depth {depth_err:.3e} (tol 2e-3)")
    assert flow_err <= 2e-4 and depth_err <= 2e-3, (flow_err, depth_err)


@contextmanager
def uncounted():
    """Keep the kernel launches of the block out of LAUNCHES: a hold of a
    kernel against its plain version, whose launches are no part of the
    path's count (they go to a recording's log, as a capture's do)."""
    from gflow_tpu_torch.ops import _build

    with _build.recording():
        yield


def rigid_lmeds_inputs(H_=H, W_=W):
    """The LMedS's inputs on the rigid scene's flow (scene_flow): x1, x2 on
    the card, the draws on the host, and the flow."""
    from gflow_tpu_torch.ops.epipolar import lmeds_draws
    from gflow_tpu_torch.pipeline.prep_moveseg import uv_grid

    flow, _ = scene_flow(H_, W_)
    x1 = torch.from_numpy(uv_grid(H_, W_).reshape(-1, 2)).cuda()
    x2 = x1 + torch.from_numpy(np.stack([2 * flow[..., 0] / (W_ - 1),
                                         2 * flow[..., 1] / (H_ - 1)], -1).reshape(-1, 2)).cuda()
    return x1, x2, lmeds_draws(H_ * W_), flow


def separated_symmetric(n, batch, seed=0):
    """Seeded symmetric (batch, n, n) float32 matrices on the card whose
    smallest eigenvalue lies 0.1-0.6 below the next."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(batch, n, n)))[0]
    lam = np.sort(rng.uniform(-1, 1, (batch, n)), axis=1)
    lam[:, 0] = lam[:, 1] - 0.1 - rng.uniform(0, 0.5, batch)
    return torch.from_numpy(((Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32)
                            ).cuda()


SMALL_EIG_RES, SMALL_EIG_DOT = 1e-5, 1e-5  # residual / |A|, 1 - |v . v_plain|


def eig_ops(n: int) -> float:
    """fp32 operations the function needs per n x n matrix: the
    Householder tridiagonal reduction of a symmetric eigensolve, 4 n^3 / 3
    (the tridiagonal eigenvalues and one eigenvector take O(n^2) more).
    Jacobi's sweeps are the design's cost, not the function's."""
    return 4 * n ** 3 / 3


def small_eig_ptxas(log: str) -> dict:
    """ptxas's report (-Xptxas -v) of small_eig.cu's instantiations: n ->
    {layout ("warp" or "thread"; an older source's small_eig_kernel is one
    thread per matrix), regs, smem_bytes, spill_stores}."""
    import re

    out, n = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*small_eig_(?:(warp|thread)_)?kernelILi(\d+)E",
                      line)
        if m:
            n = int(m.group(2))
            out[n] = {"layout": m.group(1) or "thread", "regs": None, "smem_bytes": 0,
                      "spill_stores": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and n is not None:
            out[n]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and n is not None:
            out[n]["regs"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[n]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return dict(sorted(out.items()))


def lmeds_eig_inputs():
    """The four eigenproblems of one eager LMedS on the rigid scene's
    854x480 flow (rigid_lmeds_inputs), in order: the 512 minimal samples'
    A^T A (9 x 9) and F^T F (3 x 3), then the refit's one of each."""
    from gflow_tpu_torch.ops import epipolar
    from gflow_tpu_torch.opt.graphs import disable_graphs

    x1, x2, draws, _ = rigid_lmeds_inputs()
    seen, solve = [], epipolar.smallest_eigvec

    def record(M):
        seen.append(M.detach().clone())
        return solve(M)

    with uncounted(), disable_graphs(), mock.patch.object(epipolar, "smallest_eigvec", record):
        epipolar.find_fundamental_lmeds(x1, x2, draws=draws)
    assert [tuple(M.shape) for M in seen] == [(512, 9, 9), (512, 3, 3), (9, 9), (3, 3)], [
        M.shape for M in seen]
    return dict(zip(("lmeds 9x9", "lmeds 3x3", "refit 9x9", "refit 3x3"),
                    (M.reshape(-1, *M.shape[-2:]) for M in seen)))


def small_eig_rows(inputs):
    """small_eig against its plain version (torch.linalg.eigh's
    eigenvector) on the card: seeded separated spectra, 512 matrices of 9
    x 9 and 3 x 3 (residual |A v - l v| / |A| <= SMALL_EIG_RES, |v .
    v_plain| >= 1 - SMALL_EIG_DOT), and the LMedS's own four eigenproblems
    (lmeds_eig_inputs: 512 and 1 of 9 x 9 and of 3 x 3; the 9 x 9 are
    near-singular by construction: residual held, the dot reported);
    kernel (n launches in a CUDA graph), plain version and
    torch.linalg.eigh timed; the bound from the function's bytes and
    operations (eig_ops); ptxas's registers and shared memory of the
    instantiation that ran (small_eig_ptxas)."""
    from gflow_tpu_torch.ops import _build, epipolar

    ptxas = small_eig_ptxas(_build.BUILD_LOGS.get("small_eig.cu", ""))
    rows = {}
    for where, A in (("synthetic 9x9", separated_symmetric(9, 512)),
                     ("synthetic 3x3", separated_symmetric(3, 512, seed=1)),
                     *lmeds_eig_inputs().items()):
        n = A.shape[-1]
        v = epipolar.small_eig(A)
        want = epipolar.smallest_eigvec_plain(A)
        lam = torch.einsum("bi,bij,bj->b", v, A, v)
        res = float((torch.linalg.vector_norm(A @ v[..., None] - lam[:, None, None]
                                              * v[..., None], dim=(1, 2))
                     / torch.linalg.matrix_norm(A)).max())
        dot = float((v * want).sum(-1).abs().min())
        assert res <= SMALL_EIG_RES, (where, res)
        if where.startswith("synthetic"):
            assert dot >= 1 - SMALL_EIG_DOT, (where, dot)
        t_b, by = bound(A.shape[0] * eig_ops(n), A.numel() * 4 + v.numel() * 4)
        sign = torch.where((v * want).sum(-1, keepdim=True) < 0, -1.0, 1.0)
        rows[where] = {
            "batch": A.shape[0], "n": n,
            "max_abs_err": float((v - sign * want).abs().max()),
            "residual": res, "min_abs_dot": dot,
            "ms": kernel_ms(lambda: epipolar.small_eig(A)),
            "plain_ms": cuda_ms(lambda: epipolar.smallest_eigvec_plain(A)),
            "library_ms": cuda_ms(lambda: torch.linalg.eigh(A)),
            "bound_ms": t_b, "bound_by": by, "ptxas": ptxas.get(n, "no build log")}
    return {"small_eig": rows}


def prep_phase():
    """The prior preparation on the card, as a user runs it before a fit:
    prep_flow, prep_moveseg (on prep_flow's flows) and prep_depth on a
    4-frame 854x480 sequence, at the released model widths, every compiled
    path as CUDA graphs, its launches counted as "prep": none of K1-K4 and
    small_eig in each LMedS; then prep_flow and prep_depth with
    --mesh-devices 2 against 0 (prep_mesh_hold)."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    seq = prep_sequence()
    stage_graphs.REPLAYS.clear()
    with counted("prep"):
        flows, gmflow_sd = prep_flow_phase(seq)
        prep_moveseg_phase(seq, flows)
        mast3r = prep_depth_phase(seq)
    launches = LAUNCHES_BY_PATH["prep"]
    log(f"# prep launches {launches}")
    assert not any(v for k, v in launches.items() if k != "small_eig"), launches
    assert launches.get("small_eig", 0) == 4 * 3, f"the prep path launched {launches}"
    prep_mesh_hold(seq, gmflow_sd, mast3r)


def sam_decode_phase():
    """One decode of the automatic grid's batch (64 prompts) through its
    graph, as prep_mask runs it, at the released decoder widths (seeded
    weights; the encoder is not run): finite masks, its launches counted as
    "sam decode"."""
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.sam import SamConfig, SamModel, convert
    from gflow_tpu_torch.pipeline import prep_mask

    cfg = SamConfig(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
                    encoder_global_attn_indexes=(1,),  # the encoder is not run
                    image_size=SAM_GRID * 16)
    model = SamModel(cfg)
    model.load_state_dict(seeded_state_dict(convert.expected_torch_keys(cfg), 0, 1.0))
    model = model.eval().cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    emb = torch.randn(1, SAM_C, SAM_GRID, SAM_GRID, generator=g, device="cuda")
    pts = torch.rand(SAM_B, 2, generator=g, device="cuda") * cfg.image_size
    with torch.inference_mode():
        prep_mask.decode(model, emb, pts, torch.device("cuda"))  # records its graph
        with counted("sam decode"):
            out = prep_mask.decode(model, emb, pts, torch.device("cuda"))
    assert all(bool(torch.isfinite(t).all()) for t in out), "decode"
    log(f"# SAM decode of {SAM_B} prompts (graph) launches {LAUNCHES_BY_PATH['sam decode']}")


TRACK_DIR = os.path.join(FIT_DIR, "track")


def track_phase():
    """prep_track as a user runs it, at SAM 2.1 Hiera-L's released widths
    (seeded weights, the object score's bias 2 so that the object reads
    present), on write_sequence's 4 frames (854x480 JPEG) with the moving
    square's _open.png as the one object, its parts as CUDA graphs: a first
    run records the graphs, the second's launches are counted as
    "prep_track": the decoder's four kernels once a frame's decode (frame 0
    takes its mask as the output, with the mask as a dense prompt a cell;
    frames 1-3 one image an object); a mask file of the frame's size a
    frame, the same in both runs."""
    import shutil

    from PIL import Image

    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.sam2 import Sam2Config, Sam2Model, convert
    from gflow_tpu_torch.pipeline import prep_track

    shutil.rmtree(TRACK_DIR, ignore_errors=True)
    seq = str(write_sequence(TRACK_DIR))
    sd = seeded_state_dict(convert.expected_torch_keys(), 0, 1.0)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(2.0)
    model = Sam2Model(Sam2Config())
    model.load_state_dict(sd, strict=True)
    model = model.eval().cuda()
    masks, t = [], []
    for run in range(2):
        t0 = time.perf_counter()
        with counted("prep_track") if run else contextlib.nullcontext():
            out = prep_track.main(seq, model=model)
        t.append(time.perf_counter() - t0)
        masks.append([np.asarray(Image.open(os.path.join(out, f"{f:05d}.png")))
                      for f in range(4)])
    assert all(m.shape == (H, W) for m in masks[1]), [m.shape for m in masks[1]]
    assert all(np.array_equal(a, b) for a, b in zip(*masks)), "prep_track runs differ"
    launches = LAUNCHES_BY_PATH["prep_track"]
    log(f"# prep_track, 4 frames of 854x480, 1 object: {t[0]:.1f} s recording, {t[1]:.2f} s "
        f"replaying; mask pixels {[int((m > 127).sum()) for m in masks[1]]}; launches "
        f"{launches}")
    want = {"sam_stream_init": 4, "sam_t2i_attend": 4 * 3, "sam_i2t_attend": 4 * 2,
            "sam_residual_ln": 4 * 2}
    assert {k: launches.get(k, 0) for k in want} == want, launches


# ---------------------------------------------------------------------------
# multi-GPU: the scene sweep and the tile-band fit_video
# ---------------------------------------------------------------------------

MULTI_DIR = os.path.join(FIT_DIR, "multi")


def card_list(n):
    """n devices over the visible cards, round robin: with one card every
    entry is cuda:0."""
    return tuple(torch.device("cuda", i % torch.cuda.device_count()) for i in range(n))


def fit_multi_hold(fit, devices=None):
    """fit_scenes over one copy of the fit_video phase's sequence per entry
    of `devices` (default card_list(max(2, cards)): two workers on cuda:0
    with one card), one spawned worker each, at the fit_video phase's
    depth: each scene's checkpoints and its final frame's PSNR (the final
    checkpoint rendered by a trainer) above PSNR_FLOOR."""
    import shutil

    from gflow_tpu_torch.core.io import load_image
    from gflow_tpu_torch.parallel.scene_sweep import fit_scenes
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

    devices = [str(d) for d in (devices or card_list(max(2, torch.cuda.device_count())))]
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    seqs = [write_sequence(os.path.join(MULTI_DIR, f"scene{i}")) for i in range(len(devices))]
    res = fit_scenes(seqs, fit_kwargs=FIT, devices=devices)
    psnr = []
    for seq in seqs:
        d = res[str(seq)]
        ckpts = sorted(os.listdir(os.path.join(d, "ckpt")))
        assert len(ckpts) == 3, (d, ckpts)
        gt = load_image(os.path.join(str(seq), "00002.jpg"))
        shell = GFlowTrainer(gt, num_points=N_POINTS, make_logs=False,
                             render_config=fit["render_config"])
        shell.load_checkpoint(os.path.join(d, "ckpt", ckpts[-1]))
        final = shell.render_views(("rgb",))["rgb"].cpu().numpy()
        psnr.append(float(-10 * np.log10(np.mean((final - gt) ** 2))))
    assert min(psnr) > PSNR_FLOOR, psnr
    log(f"# fit_multi: {len(devices)} scenes over {devices} in spawned workers; final frame "
        f"PSNR {psnr} (floor {PSNR_FLOOR})")


def shard_fit_video():
    """With two or more cards: fit_video(shard_devices=count) at the cut
    depth end to end, every stage banded over the cards, as CUDA graphs
    (its stages and renders replaying graphs that span the cards), its
    launches counted as "shard_devices"."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    count = torch.cuda.device_count()
    stage_graphs.REPLAYS.clear()
    with counted("shard_devices"):
        trainer, _, _ = run_fit_video(os.path.join(MULTI_DIR, "shard"), None,
                                      shard_devices=count)
    replays = dict(stage_graphs.REPLAYS)
    assert trainer.render_config.band_devices == card_list(count), trainer.render_config
    assert replays.get("step", 0) > 0, replays
    psnr, fill = fit_video_outputs(trainer)
    assert psnr > PSNR_FLOOR and fill > 50, (psnr, fill)
    log(f"# fit_video shard_devices={count}: PSNR {psnr:.3f} dB; launches "
        f"{LAUNCHES_BY_PATH['shard_devices']}; graph replays {json.dumps(replays)}")


# ---------------------------------------------------------------------------
# the kernel table
# ---------------------------------------------------------------------------

# One entry per hand-written kernel: its name, what it stands in for, and
# the timer of its family, which holds each kernel it covers against its
# plain version and times it: timer(inputs) -> {kernel: {input: row}}, the
# first row the headline. inputs: the main path's packed inputs and sorted
# streams (main_path_inputs), the eval's and the viewer's first packed
# compositor input, the eval's first sorted stream. Its source file comes
# from _build.KERNELS.
KERNEL_TABLE = (
    ("composite_fwd", "gflow_tpu/ops/pallas_raster.py:127 _fwd_kernel", compositor_rows),
    ("composite_fwd_cov", "gflow_tpu/ops/pallas_raster.py:127 _fwd_kernel, with_cov",
     compositor_rows),
    ("composite_bwd", "gflow_tpu/ops/pallas_raster.py:172 _bwd_kernel", compositor_rows),
    ("bin_tail", "gflow_tpu/ops/binning.py:293 _rotate_pack_kernel and the searchsorted "
                 "and gathers around it", tail_rows),
    ("small_eig", "XLA's eigh and svd in gflow_tpu/ops/epipolar.py:34 _solve_f (no Pallas "
                  "kernel)", small_eig_rows),
    ("stamp", "nothing: a jitted loop has no timer inside (no Pallas kernel)", stamp_rows),
    ("ssim_fwd", "XLA's fused SSIM in gflow_tpu/opt/losses.py ssim (no Pallas kernel): the "
                 "plain version's elementwise launches", ssim_rows),
    ("ssim_bwd", "the backward of the same", ssim_rows),
    ("sam_stream_init", "SAM's decoder (no JAX counterpart): the broadcast add of the dense "
                        "prompt and the PE, the strided views", sam_rows),
    ("sam_t2i_attend", "SAM's decoder: the token-to-image attention's head copies, "
                       "materialised scores and softmax", sam_rows),
    ("sam_i2t_attend", "SAM's decoder: the image-to-token attention's Q copy, scores and "
                       "softmax", sam_rows),
    ("sam_residual_ln", "SAM's decoder: keys + out_proj, norm4 and the next keys + key_pe",
     sam_rows),
)


def kernel_table(inputs):
    """Every entry of KERNEL_TABLE timed, each family's timer called once;
    each row logged. Returns the kernels JSON list: per kernel its source,
    what it stands in for, the headline row's numbers, the other rows by
    input, and its launches on every path of LAUNCHES_BY_PATH (0 where it
    does not run)."""
    from gflow_tpu_torch.ops import _build

    out, families = [], {}
    for name, replaces, timer in KERNEL_TABLE:
        if timer not in families:
            families[timer] = timer(inputs)
        rows = families[timer][name]
        for where, row in rows.items():
            log(f"# {name} {where}: {json.dumps(row)}")
        (first, head), *rest = rows.items()
        out.append({"name": name, "route": "cuda",
                    "source": f"gflow_tpu_torch/csrc/{_build.KERNELS[name][0]}",
                    "replaces": replaces, "input": first, **head, "other_inputs": dict(rest),
                    "launches": {path: n.get(name, 0) for path, n in LAUNCHES_BY_PATH.items()}})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from gflow_tpu_torch.ops import _build

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    log(f"# python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    _build.build_all()
    log(f"# nvcc build of {sorted({s for s, _, _ in _build.KERNELS.values()})}: "
        f"{time.perf_counter() - t0:.1f} s")
    build_report()
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    scene = bench_scene()
    inputs = {"main": timed("main path inputs", main_path_inputs, scene)}
    unbanded = timed("main path", main_path, scene)
    timed("banded stages", banded_phase, scene, inputs["main"], unbanded)
    timed("canonical frame", canonical_frame, scene)
    fit = timed("fit_video", fit_video_phase)
    inputs["eval"], inputs["eval_stream"] = timed("eval", eval_phase, fit)
    inputs["viewer"] = timed("viewer", viewer_phase, fit)
    timed("prep", prep_phase)
    timed("sam decode", sam_decode_phase)
    timed("prep_track", track_phase)
    timed("fit_multi", fit_multi_hold, fit)
    if torch.cuda.device_count() > 1:
        timed("shard_devices", shard_fit_video)
    kernels = timed("kernel table", kernel_table, inputs)
    log(f"# chip_smoke wall time {time.perf_counter() - t_start:.1f} s; by phase (s) "
        f"{json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
