"""Smoke run of the PyTorch/CUDA port on the visible GPUs (one suffices).

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
   the full stage's projection, and beside torch.searchsorted; the SSIM
   kernels (ssim_fwd, ssim_bwd) against the plain version and autograd
   through it at the fit's 854x480x3, timed beside their bound and the
   plain forward and backward; the SAM mask decoder's image-stream kernels
   (sam_stream_init, sam_t2i_attend, sam_i2t_attend, sam_residual_ln)
   against their plain versions at the automatic grid's batch (64
   prompts, 64x64x256, 7 tokens), timed beside their bound, the plain
   version and, for the attentions, scaled_dot_product_attention; one
   64-prompt decode's graph replay, its launches and its device kernels;
4. drives the port's main path — the per-frame fit of bench.py's scene
   (854x480, 50,000 points, capacity 51,200, seed 0, M=8 / K=96) — with
   the launch counters reset just before and read just after: a short
   camera-only stage, a full stage with an occluded-region densify and one
   error densify, and the next frame's camera-only stage, each stage as
   CUDA graphs (the default); checks the loss falls, n_alive grows by the
   expected count, every kernel launched, inside graph replays too, and
   the first iteration's gradients of every parameter leaf (both stages),
   the loss trajectory and a multi-output render match the same run on
   the plain PyTorch versions (also on the card), and a 20-iteration full
   stage's loss gap to DRIFT_RTOL (float32 rounding amplified by Adam:
   scripts/torch_stage_spread.py); then holds those stages, a
   rebin_every=4 and a snapshot_every=5 stage as graphs against the same
   stages eager (opt.graphs.disable_graphs): 0 apart, the same launch
   counts; and a full stage with stamps (ops/stamp.py, what a trainer
   with telemetry runs) against the same stage without, as CUDA graphs:
   0 apart, the stamp kernel 5 times an iteration and every other kernel
   as often, every piece of every iteration positive;
5. drives the port's fit_video (gflow_tpu_torch.pipeline.fit_video.main)
   on a synthetic 4-frame sequence at 854x480 (tests/synth.py's static
   camera layout, JPEG frames, 3 frames fitted) with 50,000 points, the
   counters reset
   just before and read just after: frame 0 on the snapshot path, then per
   frame a camera-only stage and a full stage with its occ densify and
   one error densify; depth cut to FIT's iterations. Checks every kernel
   launched (the stamp kernel 5 times an iteration: fit_video's trainer
   has telemetry; ssim_bwd once an iteration), the log directory
   (checkpoint schema, videos, pickles), the final PSNR and the move
   segmentation; renders the final checkpoint
   (render_scene) and the trajectory line set through the kernels and
   through the plain versions, and the checkpoint loaded into a trainer;
   runs a rebin_every=4 stage through both, and holds the lists rebuilt
   after a densify against per-iteration binning; holds every call the
   fitted trainer makes as a CUDA graph (diagnostic views, render_views,
   the trajectory image, project_points, gather_project, render2img's
   quantization) against the same call eager: 0 apart, the same launches;
   runs fit_video again eager (s/frame and the diagnostic-render and
   trajectory-eval medians, graphed and eager); prints the
   trainer's RenderConfig, K escalations, host libraries, native hull and
   its telemetry beside the card's name and power limit;
6. scores that fit with the port's benchmark (eval.benchmark.main: the
   four suites, LPIPS with seeded random weights written by the port's
   converter) on the card, the counters reset just before and read just
   after, and again on the plain versions: PSNR, J, F, ATE and RPE
   identical, OA / AJ / APTS identical or within one query-frame's share,
   SSIM and LPIPS within 1e-5 relative of the CPU's; the tracking renders
   and projections replayed as CUDA graphs, and the same suite eager
   gives the same OA / AJ / APTS; prints the seconds of each suite, the
   tracking render's RenderConfig (two-class binning) and its K1 calls by
   (K, F); holds the tracking render as a graph, captured and replayed
   under sync_check("error"), against eager, and times the tracking suite
   graphed and eager in turns;
7. views it with the port's viewer (viz.viewer.ViewerState on the card):
   every frame in follow mode, one orbit and one free 6-DoF pose held
   against the plain versions to 1e-5 (hold_composite: but for the rare
   pixel where a slot's alpha sits on its 1/255 step, which the kernel and
   the plain version may round to opposite sides, or where the float32
   rounding of the blend, large under an ill-conditioned splat, accounts
   for the difference; the difference there is held to what that slot and
   that rounding can move), each view's request (render_jit and
   render2img as CUDA graphs, JPEG) against eager, 0 apart, ms per request
   (render + JPEG) graphed and eager in turns, 20 requests each, and the
   HTTP handler on 127.0.0.1 (/info, /render); then
   times K1 at K = 128 on the eval's (F = 2) and the viewer's (F = 3) own
   packed input and K4 on the eval's two-class stream;
8. drives the multi-GPU modes on the visible cards (band b and worker w
   on cuda:(b mod count); with one card all on cuda:0): (a) the band
   compositor (4 bands: 30 tile rows padded to 32) on the main path's
   packed input, K1 / K2 and K3 per band against the plain band version
   and against the unbanded kernel call; (b) the 3-stage check with the
   stages banded under a 4-band fitting_mesh, as CUDA graphs, against the
   same run unbanded and against the same banded run eager (0 apart), the
   launch counts reset just before the banded run and read just after,
   and 20 full-stage iterations timed unbanded, in 4 bands on cuda:0 and,
   with more cards, over them, each graphed and eager; (c) fit_multi on max(2,
   count) copies of the fit_video sequence in spawned workers (PSNR
   floor, scenes per minute); (d) prep_flow and prep_depth with
   mesh_devices=2 against 0; (e) with two or more cards,
   fit_video(shard_devices=count) end to end, graphed and eager;
9. times one frame at the canonical budget (150 camera + 300 full
   iterations, occ densify at 0 and error densify every 100 x2) after one
   warm-up frame, as CUDA graphs and eager, one frame each; profiles a
   10-iteration full stage, graphed and eager (device kernels and graph
   launches per iteration, idle share; Chrome traces written to
   logs/chip_smoke/profile/{graphed,eager}/trace.json) and, alone, the
   binning layer (bin_gaussians) on each stage's first-iteration input;
10. prints the kernels JSON line (with each kernel's launches in the main
   path, in fit_video, in the eval, in the viewer, in prep and in the
   multi-GPU phase's banded stages; small_eig's, the prep path's own
   kernel, with its launches in prep; stamp's, with its launches in the
   stamped stage and in fit_video; ssim_fwd's and ssim_bwd's, with their
   launches in the main path and fit_video; the SAM decoder's four, with
   their launches a decode), then as its last line
   {"ok": true, "device": {...}}.

The prep phase (between 7 and 8) prepares a second 4-frame sequence's
priors as a user does: prep_flow (GMFlow at the released width),
prep_moveseg (the LMedS) and prep_depth (MASt3R ViT-L at 512x288, 10
pairs, the 700-step global alignment), each compiled path as CUDA graphs,
the counts reset just before and read just after (no K1-K4; small_eig 4
times a frame); holds each model, the occlusion and the error map against
the CPU; small_eig against its plain version (torch.linalg.eigh) on
separated spectra (residual and eigenvector bounds), on the LMedS's own
four eigenproblems (512 and 1 of 9 x 9 and of 3 x 3: residual bound) and
through the LMedS, each with ptxas's registers and shared memory; every
compiled path (global_align, one GMFlow and one MASt3R pair, the LMedS,
the B-frame step) graphed against eager, 0 apart with equal launches, all
but global_align recorded in empty caches under sync_check("error"); its
graphs' nodes, capture and instantiate seconds and pool bytes; then the
three stages in turns, graphed and eager (stage walls, s per pair, LMedS
ms and s per frame, ms per Adam step, the B-frame step's ms at the fit's
width: 2 frames of 854x480, capacity 51,200).

Any failure raises and exits nonzero. A failing kernel-vs-plain hold of
the compositor (hold_composite) first saves its call under
logs/chip_smoke/hold_failures/ (scripts/torch_replay_composite.py replays
it). Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import io
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
SMI = "not read"  # nvidia-smi's name and power limit line, set by main()
# the fit's kernels (K1-K4); small_eig runs on the prep path only
FIT_KERNELS = ("composite_fwd", "composite_fwd_cov", "composite_bwd", "bin_tail")
# fp32 operations per (pixel, live slot) that the function needs, counted
# from csrc/composite.cu: alpha 17 (dx dy 2, power 9, min+exp+mul+clamp 4,
# masks 2); K1 adds w 1 + feat 2F + T 2, K2 adds mul+max 2. K3 evaluates
# alpha 17, fg 2F, w 1 and T 2 once (its second pass repeats them: that is
# the design's cost, not the function's), plus the suffix sum S_k 2 (w fg,
# add), dalpha 5, dpower 1, moments 5, dfeat F, one add per reduced value 6+F
OPS_K1 = lambda F: 20 + 2 * F
OPS_K2 = lambda F: 22 + 2 * F
OPS_K3 = lambda F: 39 + 4 * F
# fp32 operations per (pixel, channel) of SSIM, counted from csrc/ssim.cu:
# forward x^2 y^2 xy 3, five maps x 11 taps x 2 passes x (mul, add) 220, the
# map 17, the coefficient maps 14, the mean 1; backward three maps x 11
# taps x 2 passes x 2 = 132, the combination 6. Bytes: x and y in and the
# three maps out (forward); the maps, x and y in and dL/dx out (backward)
OPS_SSIM_FWD, OPS_SSIM_BWD = 255, 138
BYTES_SSIM_FWD, BYTES_SSIM_BWD = 4 * 5, 4 * 6


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


def ssim_rows(shape=(H, W, 3)):
    """ssim_fwd and ssim_bwd against the plain version on the fit's image
    shape: the mean SSIM's error, dL/dimg1's normalized by its max |ref|
    (1e-5: tests/test_torch_cuda.py), the kernels' device times (fwd with
    its coefficient maps, bwd) beside their bounds and the plain forward's
    and forward + backward's."""
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
    fwd_ms = kernel_ms(lambda: ssim_ops.ssim_fwd(x, y, with_coef=True))
    bwd_ms = kernel_ms(lambda: ssim_ops.ssim_bwd(x, y, coef, one))
    plain_fwd_ms = cuda_ms(lambda: ssim_ops.ssim_plain(x, y), reps=5)
    plain_ms = cuda_ms(lambda: grad(ssim_ops.ssim_plain), reps=5)
    rows = {}
    for name, ms, ops, nbytes, plain, e in (
            ("ssim_fwd", fwd_ms, OPS_SSIM_FWD, BYTES_SSIM_FWD, plain_fwd_ms, err),
            ("ssim_bwd", bwd_ms, OPS_SSIM_BWD, BYTES_SSIM_BWD, plain_ms, g_err)):
        b_ms, b_by = bound(n * ops, n * nbytes)
        rows[name] = dict(shape=list(shape), ms=ms, bound_ms=b_ms, bound_by=b_by,
                          plain_ms=plain, max_abs_err=e, max_norm_err=norm_err)
    log(f"# SSIM {'x'.join(map(str, shape))} ({SMI}): ssim_fwd {fwd_ms:.4f} ms (bound "
        f"{rows['ssim_fwd']['bound_ms']:.4f}, {rows['ssim_fwd']['bound_by']}), ssim_bwd "
        f"{bwd_ms:.4f} ms (bound {rows['ssim_bwd']['bound_ms']:.4f}, "
        f"{rows['ssim_bwd']['bound_by']}); plain forward {plain_fwd_ms:.4f} ms, plain "
        f"forward + backward {plain_ms:.4f} ms; |SSIM - plain| {err:.3e}, dL/dimg1 max err "
        f"normalized {norm_err:.3e}")
    return rows


# SAM's mask decoder at the automatic grid's batch: 64 prompts, a 64 x 64
# grid of 256 channels, 7 tokens, cross attention 8 heads of 16
SAM_B, SAM_GRID, SAM_C, SAM_I, SAM_T = 64, 64, 256, 128, 7


def sam_decoder_work(B, N, C=SAM_C, I=SAM_I, T=SAM_T):
    """fp32 operations and bytes each image-stream kernel's function needs
    (each input byte read once, each output written once), by kernel name.
    An attention: per (prompt, token, head, image row) a dot of 16 and a
    weighted sum of 16 (4 I a (token, row) pair), the scale, max, exp and
    sum (~5 a head); the norm ~10 a value; stream_init one add a value."""
    att_ops = B * T * N * (4 * I + 5 * 8)
    return {
        "sam_stream_init": (C * N + B * N * C, 4 * (2 * C * N + C + 2 * B * N * C)),
        "sam_t2i_attend": (att_ops, 4 * (2 * B * T * I + 2 * B * N * I)),
        "sam_i2t_attend": (att_ops, 4 * (2 * B * N * I + 2 * B * T * I)),
        "sam_residual_ln": (10 * B * N * C, 4 * (4 * B * N * C + N * C + 2 * C)),
    }


def sam_decoder_rows():
    """The decoder's image-stream kernels (ops/sam_decoder.py) against their
    plain versions at the grid's shapes: max error relative to the largest
    value, device ms beside the bytes' bound and the plain version's ms;
    for the attentions also torch's scaled_dot_product_attention on
    head-major copies made beforehand (library_ms: a yardstick the port
    never calls). Then one 64-prompt decode (prep_mask.decode, its CUDA
    graph) at the released decoder widths: its ms, its launches, and its
    device kernels by time under torch.profiler."""
    import torch.nn.functional as F

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.ops import sam_decoder as sd
    from gflow_tpu_torch.pipeline import prep_mask

    B, N, heads = SAM_B, SAM_GRID ** 2, 8
    g = torch.Generator(device="cuda").manual_seed(6)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale
    image, dense, pe = r(1, SAM_C, SAM_GRID, SAM_GRID), r(SAM_C), r(N, SAM_C)
    q_t, k_n, v_n = r(B, SAM_T, SAM_I, scale=2.0), r(B, N, SAM_I), r(B, N, SAM_I)
    q_n, k_t, v_t = r(B, N, SAM_I, scale=2.0), r(B, SAM_T, SAM_I), r(B, SAM_T, SAM_I)
    keys, out, w, b = r(B, N, SAM_C), r(B, N, SAM_C), r(SAM_C), r(SAM_C)
    heads_major = lambda t: t.reshape(*t.shape[:2], heads, -1).transpose(1, 2).contiguous()
    calls = {
        "sam_stream_init": (lambda: sd.stream_init(image, dense, pe, B),
                            lambda: sd.stream_init_plain(image, dense, pe, B), None),
        "sam_t2i_attend": (lambda: sd.t2i_attend(q_t, k_n, v_n, heads),
                           lambda: sd.cross_attend_plain(q_t, k_n, v_n, heads),
                           (heads_major(q_t), heads_major(k_n), heads_major(v_n))),
        "sam_i2t_attend": (lambda: sd.i2t_attend(q_n, k_t, v_t, heads),
                           lambda: sd.cross_attend_plain(q_n, k_t, v_t, heads),
                           (heads_major(q_n), heads_major(k_t), heads_major(v_t))),
        "sam_residual_ln": (lambda: sd.residual_ln(keys, out, w, b, 1e-5, pe),
                            lambda: sd.residual_ln_plain(keys, out, w, b, 1e-5, pe), None),
    }
    work = sam_decoder_work(B, N)
    rows = {}
    for name, (kernel, plain, lib) in calls.items():
        got, want = kernel(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(float((a - c).abs().max() / c.abs().max()) for a, c in zip(got, want))
        assert err <= 1e-5, (name, err)
        b_ms, b_by = bound(*work[name])
        rows[name] = dict(ms=kernel_ms(kernel), bound_ms=b_ms, bound_by=b_by,
                          plain_ms=cuda_ms(plain, reps=5), max_rel_err=err,
                          library_ms=(kernel_ms(lambda: F.scaled_dot_product_attention(*lib))
                                      if lib else None))
        rows[name]["roofline_pct"] = 100 * b_ms / rows[name]["ms"]
    del q_t, k_n, v_n, q_n, k_t, v_t, keys, out, calls
    # one decode of the grid's batch through its graph, as prep_mask runs it
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.sam import SamConfig, SamModel, convert

    cfg = SamConfig(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
                    encoder_global_attn_indexes=(1,),  # the encoder is not run
                    image_size=SAM_GRID * 16)
    model = SamModel(cfg)
    model.load_state_dict(seeded_state_dict(convert.expected_torch_keys(cfg), 0, 1.0))
    model = model.eval().cuda()
    emb = r(1, SAM_C, SAM_GRID, SAM_GRID)
    pts = torch.rand(B, 2, generator=g, device="cuda") * cfg.image_size
    dev = torch.device("cuda")
    decode = lambda: prep_mask.decode(model, emb, pts, dev)
    with torch.inference_mode():
        decode()
        _build.LAUNCHES.clear()
        decode()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if k.startswith("sam_")}
        decode_ms = cuda_ms(decode, reps=10)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                decode()
            torch.cuda.synchronize()
    ops = sorted(((us / 3e3, c / 3, k[:70]) for us, c, k in device_rows(prof)), reverse=True)
    busy = sum(o[0] for o in ops)
    decode_row = {"ms": decode_ms, "device_busy_ms": busy if ops else "not measured",
                  "launches": launches,
                  "top": [{"name": k, "ms": ms, "calls": c} for ms, c, k in ops[:12]]}
    log(f"# SAM decoder image stream ({SMI}), B {B}, N {N}, C {SAM_C}, T {SAM_T}: " + "; ".join(
        f"{n} {x['ms']:.4f} ms (bound {x['bound_ms']:.4f}, {x['bound_by']}, "
        f"{x['roofline_pct']:.1f}%; plain {x['plain_ms']:.4f}"
        + (f", sdpa {x['library_ms']:.4f}" if x["library_ms"] else "")
        + f"; rel err {x['max_rel_err']:.2e})" for n, x in rows.items()))
    log(f"# SAM decode of {B} prompts (graph): {json.dumps(decode_row)}")
    return rows, decode_row


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
            rows[(name, K, "synthetic")] = fwd_row(attrs, counts, bg, n_tx, with_cov, "synthetic")

        # K3 against autograd through the plain version
        attrs, counts = packed_inputs(gen, T, K, F, False, n_tx)
        g = torch.randn((T, 256, F), generator=gen, device="cuda")
        rows[("composite_bwd", K, "synthetic")] = bwd_row(attrs, counts, bg, g, n_tx, False)

        for where, stream in streams.items():
            rows[("bin_tail", K, where)] = tail_row(stream, K, where)

        for stage, rec in main_inputs[K].items():
            a, c, b, nt, cov = (rec[k] for k in ("attrs", "counts", "bg", "n_tx", "with_cov"))
            name = "composite_fwd_cov" if cov else "composite_fwd"
            rows[(name, K, "main")] = fwd_row(a, c, b, nt, cov, f"main {stage}")
            rows[("composite_bwd", K, f"main {stage}")] = bwd_row(a, c, b, rec["g"], nt, cov)
        for (name, k, where), r in rows.items():
            if k == K:
                log_row(name, K, where, r)
    return rows


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
    """The correctness checks, under deterministic algorithms."""
    with deterministic():
        return _main_path(scene)


def _main_path(scene):
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs

    img, depth, intr, params, n0, rcfg = scene
    grad_check(scene)
    with plain_versions():
        plain_traces, plain_alive, _, _ = check_run(scene)
    _build.LAUNCHES.clear()
    _build.REPLAYED.clear()
    stage_graphs.REPLAYS.clear()
    traces, alive, p, out = check_run(scene)
    torch.cuda.synchronize()
    launches, replayed = dict(_build.LAUNCHES), dict(_build.REPLAYED)
    log(f"# main path launches: {launches}, of them in CUDA graph replays {replayed}; graph "
        f"replays {dict(stage_graphs.REPLAYS)}")
    for name in (*FIT_KERNELS, "ssim_fwd", "ssim_bwd"):
        assert launches.get(name, 0) > 0, f"kernel {name} never launched on the main path"
        assert replayed.get(name, 0) > 0, f"kernel {name} never launched in a graph replay"

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
    drift_check(scene)
    graph_holds(scene, (traces, alive, p, launches))
    return launches, replayed, stamp_hold(scene)


def flat_stage(p, s, info):
    """Every tensor a stage returns, by name."""
    flat = {f"params.{k}": v for k, v in p._asdict().items()}
    flat.update({f"state.{k}": v for k, v in s._asdict().items()})
    for k, v in info.items():
        for m, x in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}.{m}" if m else k] = x
    return flat


def graph_holds(scene, graphed_check):
    """The stages as CUDA graphs (the default) against the same stages
    eager (disable_graphs), deterministic (called from main_path): the
    3-stage check (the lean path with its occ and error densify, and the
    camera-only stage; graphed_check is its graphed run), a rebin_every=4
    and a snapshot_every=5 full stage of 20 iterations, each with an occ
    densify at 0 and an error densify after iteration 9. n_alive, the loss
    traces, the parameters (and every other output of the rebin and
    snapshot stages) are 0 apart, and the launch counts equal."""
    import dataclasses

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    traces, alive, p, launches = graphed_check
    _build.LAUNCHES.clear()
    with stage_graphs.disable_graphs():
        e_traces, e_alive, e_p, _ = check_run(scene)
    torch.cuda.synchronize()
    e_launches = dict(_build.LAUNCHES)
    assert e_alive == alive and e_launches == launches, (e_alive, alive, e_launches, launches)
    diff = {"check": max(max(float((a - b).abs().max()) for a, b in zip(traces, e_traces)),
                         max(float((getattr(p, k) - getattr(e_p, k)).abs().max())
                             for k in p._fields))}
    img, depth, intr, params, n0, rcfg = scene
    tg = check_targets(img, depth)
    dyn_full = dynamics()[1]
    base = StageConfig(W=W, H=H, iterations=20, render=rcfg, densify_occ=True,
                       densify_interval=10, densify_times=1, max_densify=256)
    counts = {"check": launches}
    for path, cfg in (("rebin", dataclasses.replace(base, rebin_every=4)),
                      ("snapshot", dataclasses.replace(base, snapshot_every=5))):
        runs = []
        for eager in (False, True):
            state = init_frame_state(CAPACITY)._replace(
                n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
            gen = torch.Generator(device="cuda").manual_seed(4)
            _build.LAUNCHES.clear()
            with stage_graphs.disable_graphs() if eager else contextlib.nullcontext():
                out = flat_stage(*train_stage(params, state, tg, intr, gen, cfg, dyn_full))
            torch.cuda.synchronize()
            runs.append((out, dict(_build.LAUNCHES)))
        (g, l_g), (e, l_e) = runs
        assert set(g) == set(e) and l_g == l_e, (l_g, l_e)
        diff[path] = max(float((g[k].double() - e[k].double()).abs().max())
                         for k in g if g[k].numel())
        counts[path] = {**l_g, "n_alive": int(g["n_alive"])}
    log(f"# stages as CUDA graphs vs eager (deterministic): max abs diff over n_alive, "
        f"loss traces and parameters (rebin, snapshot: every output) {json.dumps(diff)}; "
        f"launches, equal in both: {json.dumps(counts)}")
    assert not any(diff.values()), diff
    return {"max_abs_diff": diff, "launches": counts}


def stamp_hold(scene, iters=20):
    """A full stage at the main path's width and capacity (20 iterations,
    an occ densify at 0 and an error densify after iteration 9) with
    stamps (what a trainer with telemetry runs: fit_video's) and without,
    as CUDA graphs, from the same inputs, deterministic (called from
    main_path): the loss traces and parameters 0 apart, the stamp kernel
    launched 5 times an iteration and every other kernel as often as
    without, and every piece of every iteration positive on the card's
    timer. Returns the launches and each piece's ms per iteration."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.ops.stamp import COLS, pieces
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = check_targets(img, depth)
    dyn_full = dynamics()[1]
    runs = {}
    for stamps in (True, False):
        cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg, densify_occ=True,
                          densify_interval=10, densify_times=1, max_densify=256,
                          stamps=stamps)
        state = init_frame_state(CAPACITY)._replace(
            n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        _build.LAUNCHES.clear()
        p, _, info = train_stage(params, state, tg, intr, gen, cfg, dyn_full)
        torch.cuda.synchronize()
        runs[stamps] = (p, info, dict(_build.LAUNCHES))
    (p, info, launches), (p0, info0, launches0) = runs[True], runs[False]
    table = info["stamps"].cpu().numpy()
    diff = max(float((info["loss_trace"] - info0["loss_trace"]).abs().max()),
               max(float((getattr(p, k) - getattr(p0, k)).abs().max()) for k in p._fields))
    got = pieces(table)
    ms = {k: 1e3 * v / (iters - 1 if k == "between" else iters) for k, v in got.items()}
    out = {"launches": launches, "unstamped_launches": launches0, "ms_per_iter": ms,
           "max_abs_diff": diff, "n_alive": int(info["n_alive"])}
    log(f"# stamped full stage ({iters} iterations, densify) vs unstamped, CUDA graphs "
        f"(deterministic): {json.dumps(out)}")
    assert table.shape == (iters, COLS) and "stamps" not in info0
    assert diff == 0 and int(info["n_alive"]) == int(info0["n_alive"]), out
    stamped = dict(launches)
    assert stamped.pop("stamp", 0) == COLS * iters and stamped == launches0, out
    assert (np.diff(table, axis=1) > 0).all() and (table[1:, 0] >= table[:-1, -1]).all(), table
    assert all(v > 0 for v in got.values()), got
    return out


def time_frame(scene):
    """One frame at the canonical budget after one warm-up frame (which
    records the stages' CUDA graphs), then timed as graphs (the default)
    and eager (disable_graphs), one frame each (the script's time holds
    no more). Each frame starts from the one before. Returns {"graphed": [..], "eager": [..]} of per-frame
    results and their means."""
    from gflow_tpu_torch.opt import graphs as stage_graphs
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
    frames = {"graphed": [], "eager": []}
    for mode in ("warmup", "graphed", "eager"):
        _build.LAUNCHES.clear()
        with stage_graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
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
        log(f"# frame {mode}: {json.dumps(result)}")
        if mode != "warmup":
            frames[mode].append(result)
    for mode, runs in list(frames.items()):
        frames[f"{mode}_mean"] = {k: float(np.mean([r[k] for r in runs])) for k in
                                  ("cam_ms_per_iter", "full_ms_per_iter", "s_per_frame")}
    assert frames["graphed"][0]["cam_launches"] == frames["eager"][0]["cam_launches"], frames
    return frames


# ---------------------------------------------------------------------------
# the host-called renders as CUDA graphs
# ---------------------------------------------------------------------------

TURNS = ("graphed", "eager", "eager", "graphed")


def flat_arrays(tree):
    """Every tensor or array of a (nested) dict, tuple or list as a float64
    NumPy array, in a fixed order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_arrays(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for x in tree for a in flat_arrays(x)]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return [np.asarray(tree, np.float64)]


def graph_hold(call, checked=False):
    """call() as CUDA graphs (the default; with checked, under
    sync_check("error"), where any synchronising call raises) against
    call() inside disable_graphs(), both under deterministic(): 0 apart,
    the same K1-K4 launches, and the graphed run replayed its graphs.
    Returns those launches and replays (counted as increments: the
    counters run on)."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs

    runs = []
    for mode in ("graphed", "eager"):
        launched, replayed = _build.LAUNCHES.copy(), stage_graphs.REPLAYS.copy()
        torch.cuda.synchronize()
        with deterministic(), contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(stage_graphs.disable_graphs())
            elif checked:
                stack.enter_context(stage_graphs.sync_check(torch.device("cuda")))
            out = call()
        runs.append((flat_arrays(out), dict(_build.LAUNCHES - launched),
                     dict(stage_graphs.REPLAYS - replayed)))
    (g, l_g, r_g), (e, l_e, r_e) = runs
    assert [a.shape for a in g] == [a.shape for a in e], "graphed and eager outputs differ"
    diff = max((float(np.abs(a - b).max()) for a, b in zip(g, e) if a.size), default=0.0)
    assert diff == 0 and l_g == l_e and r_g and not r_e, (diff, l_g, l_e, r_g, r_e)
    return {"launches": l_g, "replays": r_g}


def in_turns(run):
    """run(mode) for each mode of TURNS: "graphed" as CUDA graphs, "eager"
    inside disable_graphs(). Returns {mode: [results in turn order]}."""
    from gflow_tpu_torch.opt.graphs import disable_graphs

    out = {"graphed": [], "eager": []}
    for mode in TURNS:
        with disable_graphs() if mode == "eager" else contextlib.nullcontext():
            out[mode].append(run(mode))
    return out


def trainer_graph_holds(trainer, traj_args):
    """Every graphed call of a fitted trainer against the same call eager
    (graph_hold): the diagnostic views, render_views, the trajectory image
    (float and uint8), project_points, gather_project and render2img's
    quantization."""
    from gflow_tpu_torch.ops.render import render2img

    n = trainer.current_pts_num()
    pts = trainer.params.xyz[:256].cpu().numpy()
    query = np.linspace(0, n - 1, 16).astype(np.int64)
    img = trainer.render_views(("rgb",))["rgb"]
    calls = {"diag": trainer._diag_views, "render_views": trainer.render_views,
             "traj": lambda: trainer.traj_image(*traj_args),
             "traj uint8": lambda: trainer.traj_image(*traj_args, as_uint8=True),
             "world2pix": lambda: trainer.project_points(pts),
             "gather_project": lambda: trainer.gather_project(query),
             "quantize": lambda: render2img(img)}
    holds = {k: graph_hold(c) for k, c in calls.items()}
    log(f"# fit_video trainer's calls as CUDA graphs vs eager (deterministic): 0 apart, equal "
        f"launches; per call launches and graph replays {json.dumps(holds)}")
    return holds


def fit_video_turns(first):
    """fit_video at the cut depth graphed and eager: `first`, the fit_video
    phase's graphed run (trainer, wall seconds), then one eager run on a
    sequence of its own (the script's time holds no more). Returns per
    mode each run's
    s/frame, wall seconds and phase medians (the diagnostic renders, the
    trajectory eval, the stages)."""
    from gflow_tpu_torch.opt.graphs import disable_graphs

    def summary(trainer, wall):
        t = trainer.telemetry.summary()
        med = {k: v["median_sec_per_call"] for k, v in t["phases"].items()}
        return {"s_per_frame": t["sec_per_frame"], "wall_s": wall,
                **{k: med.get(k) for k in ("host/diag_renders", "host/traj_eval",
                                           "camera_stage", "full_stage", "device/stage")}}

    out = {"graphed": [summary(*first)], "eager": []}
    for i, mode in enumerate(("eager",)):
        with disable_graphs() if mode == "eager" else contextlib.nullcontext():
            trainer, _, wall = run_fit_video(os.path.join(FIT_DIR, "turns", str(i)), "cuda")
        out[mode].append(summary(trainer, wall))
    log(f"# fit_video at the cut depth, graphed then eager ({SMI}): {json.dumps(out)}")
    return out


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


def fit_video_phase(scene):
    """The port's fit_video at 854x480 / 50,000 points on the card (depth
    cut: FIT), with the launch counts reset just before and read just
    after; then the final checkpoint rendered (render_scene) and the
    trajectory line set drawn through the kernels and through the plain
    versions, and the rebinning checks (rebin_check)."""
    import shutil

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.ops.render import render_scene
    from gflow_tpu_torch.ops.stamp import COLS
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer
    from gflow_tpu_torch.utils.hull import native_loaded

    shutil.rmtree(FIT_DIR, ignore_errors=True)
    libs = host_libraries()
    log(f"# fit_video: host libraries {json.dumps(libs)}; native hull library loaded: "
        f"{native_loaded()}")
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    with compositor_shapes() as shapes:
        trainer, seq, wall = run_fit_video(FIT_DIR, "cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
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

    summary = trainer.telemetry.summary()
    medians = {k: v["median_sec_per_call"] for k, v in summary["phases"].items()}
    log(f"# fit_video telemetry ({SMI}): {summary['sec_per_frame']} s/frame over "
        f"{summary['frames']} frames, {summary['opt_steps_per_sec']} steps/s, wall "
        f"{wall:.2f} s; phase medians (s): {json.dumps(medians)}")
    log(f"# fit_video telemetry summary: {json.dumps(summary)}")
    # the trainer has telemetry, so every stage stamped its iterations
    iters = summary["phases"]["iter/render"]["calls"]
    log(f"# fit_video stamps: {launches.get('stamp')} launches over {iters} iterations")
    assert launches.get("stamp") == COLS * iters, (launches.get("stamp"), iters)
    # the loss's SSIM: the backward kernel once an iteration, the forward's
    # other launches the no-grad forwards (error densify, a stage's output)
    log(f"# fit_video SSIM: ssim_fwd {launches.get('ssim_fwd')}, ssim_bwd "
        f"{launches.get('ssim_bwd')} launches over {iters} iterations")
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
    holds = trainer_graph_holds(trainer, traj_args)
    rebin = rebin_check(scene)
    turns = fit_video_turns((trainer, wall))
    return {"launches": launches, "telemetry": summary, "psnr": psnr, "seg_fill": fill,
            "render_err": errs, "rebin": rebin, "shapes": dict(shapes),
            "log_dir": trainer.dir, "sequence": str(seq), "render_config": rc,
            "trainer": trainer, "graph_holds": holds, "turns": turns}


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


def rebin_check(scene, iters=20):
    """A full stage with rebin_every=4 through the kernels and through the
    plain versions, deterministic: the loss traces agree to rtol 1e-2 (see
    _main_path). No densify there: an occ densify at iteration 0 takes the
    two traces to ~1e-2 apart by iteration 20 with or without rebinning
    (scripts/torch_stage_spread.py). The lists rebuilt right after a
    densify are held instead against the kernels' own per-iteration
    binning: with an occ densify after iteration 0, rebin_every=4's
    iterations 0 and 1 run on the lists that rebin_every=1 bins in its own
    forward (the same parameters, the same generator), so the two losses
    agree there to rtol 1e-5; lists left from before the densify would miss
    the new points in iteration 1."""
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = check_targets(img, depth)
    _, dyn_full = dynamics()
    cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg, rebin_every=4)
    traces = []
    for plain in (False, True):
        state = init_frame_state(CAPACITY)._replace(
            n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        with deterministic(), (plain_versions() if plain else contextlib.nullcontext()):
            _, _, info = train_stage(params, state, tg, intr, gen, cfg, dyn_full)
        traces.append(info["loss_trace"].cpu())
    torch.testing.assert_close(traces[0], traces[1], rtol=1e-2, atol=1e-5)
    rel = float(((traces[0] - traces[1]).abs() / traces[1].abs()).max())
    log(f"# rebin_every=4 full stage ({iters} iterations) matches plain path (rtol 1e-2; "
        f"max rel diff {rel:.3e}): {traces[0][0]:.5f}->{traces[0][-1]:.5f}")
    post = []
    for every in (4, 1):
        state = init_frame_state(CAPACITY)._replace(
            n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(6)
        cfg = StageConfig(W=W, H=H, iterations=4, render=rcfg, rebin_every=every,
                          densify_occ=True, max_densify=256)
        with deterministic():
            _, _, info = train_stage(params, state, tg, intr, gen, cfg, dyn_full)
        post.append((int(info["n_alive"]), info["loss_trace"][:2].cpu()))
    (n_rebin, l_rebin), (n_every, l_every) = post
    assert n_rebin == n_every == n0 + 256, (n_rebin, n_every)
    torch.testing.assert_close(l_rebin, l_every, rtol=1e-5, atol=0)
    post_rel = float(((l_rebin - l_every).abs() / l_every.abs()).max())
    log(f"# rebin_every=4 after an occ densify (+256 points): iterations 0-1 match "
        f"per-iteration binning (rtol 1e-5; max rel diff {post_rel:.3e})")
    return {"max_rel": rel, "post_densify_max_rel": post_rel}


# ---------------------------------------------------------------------------
# eval and viewer: what a user does with the fit
# ---------------------------------------------------------------------------

SUITES = ("eval_reconstruction", "eval_tracking", "eval_segmentation", "eval_camera")


@contextmanager
def timed_suites():
    """Seconds of each benchmark suite while the block runs (each call
    synchronizes the card before its clock stops)."""
    from gflow_tpu_torch.eval import benchmark

    seconds = {}

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return res
        return run

    with contextlib.ExitStack() as stack:
        for name in SUITES:
            stack.enter_context(mock.patch.object(benchmark, name,
                                                  timed(name, getattr(benchmark, name))))
        yield seconds


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
    fit_video's log directory and sequence, on the card with the launch
    counts reset just before and read just after, then again on the plain
    versions. Holds PSNR, J, F, ATE and RPE identical, OA / AJ / APTS
    identical or within one query-frame's share, and SSIM and LPIPS within
    1e-5 relative of the same suite on the CPU. Returns the launches and
    the packed compositor input and sorted stream of the first tracking
    render."""
    import pickle

    from gflow_tpu_torch.core.io import load_image
    from gflow_tpu_torch.eval import benchmark
    from gflow_tpu_torch.eval.metrics import LPIPS_WEIGHTS_ENV
    from gflow_tpu_torch.ops import _build
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

    _build.LAUNCHES.clear()
    stage_graphs.REPLAYS.clear()
    torch.cuda.synchronize()
    with compositor_shapes() as shapes, timed_suites() as secs:
        got = benchmark.main(log_dir, seq, csv_name="chip_smoke", device="cuda")
    torch.cuda.synchronize()
    launches, replays = dict(_build.LAUNCHES), dict(stage_graphs.REPLAYS)
    # one tracking render and one projection per checkpoint, all replays
    assert replays.get("render") == 3 and replays.get("world2pix") == 3, replays
    track_keys = ("Occlusion_Accuracy", "Average_Jaccard", "Average_PTS_within_threshold")
    # the compositor's and the binning's inputs, recorded as the calls run
    with stage_graphs.disable_graphs(), capture_packed() as packed, \
            capture_binning() as binned:
        eager_track = benchmark.eval_tracking(seq, log_dir, device="cuda")
    assert list(eager_track) == [got[k] for k in track_keys], (eager_track, got)
    with stage_graphs.disable_graphs(), plain_versions(), timed_suites() as plain_secs:
        want = benchmark.main(log_dir, seq, csv_name="chip_smoke_plain", device="cuda")
    cpu = benchmark.eval_reconstruction(log_dir, seq, device="cpu")
    log(f"# eval ({SMI}) kernels: {json.dumps(got)}; seconds per suite "
        f"{json.dumps(secs)}")
    log(f"# eval ({SMI}) plain versions: {json.dumps(want)}; seconds per suite "
        f"{json.dumps(plain_secs)}")
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
    hold = tracking_graph_hold(log_dir, seq)
    turns = tracking_turns(log_dir, seq, [got[k] for k in track_keys])
    return {"launches": launches, "replays": replays, "packed": packed[0],
            "stream": binned["streams"][0], "graph_hold": hold, "turns": turns}


def tracking_graph_hold(log_dir, seq):
    """The tracking suite's render (a trainer as eval_tracking builds it:
    RenderConfig.for_scene at 1000 points, two-class binning, K = 128, on
    the first checkpoint) as a CUDA graph, captured and replayed under
    sync_check("error"), against the same render eager (graph_hold)."""
    from gflow_tpu_torch.core.io import load_image
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

    tr = GFlowTrainer(load_image(os.path.join(seq, "00000.jpg")), num_points=1000,
                      make_logs=False, device="cuda")
    tr.load_checkpoint(os.path.join(log_dir, "ckpt", sorted(os.listdir(
        os.path.join(log_dir, "ckpt")))[0]))
    rc = tr.render_config
    assert rc.small_tiles_per_gaussian > 0 and rc.max_per_tile == 128, rc
    hold = graph_hold(lambda: tr.render_views(("uv", "depth", "depth_map", "acc")),
                      checked=True)
    log(f"# eval tracking render (two-class binning, M={rc.max_tiles_per_gaussian} "
        f"K={rc.max_per_tile}) captured and replayed under sync_check('error'), graphed vs "
        f"eager (deterministic): 0 apart, equal launches {json.dumps(hold)}")
    return hold


def tracking_turns(log_dir, seq, metrics):
    """The tracking suite's seconds (eval_tracking, synchronized) in TURNS,
    graphed and eager; every run gives `metrics` (OA, AJ, APTS)."""
    from gflow_tpu_torch.eval import benchmark

    def run(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = benchmark.eval_tracking(seq, log_dir, device="cuda")
        torch.cuda.synchronize()
        assert list(res) == metrics, (mode, res, metrics)
        return time.perf_counter() - t0

    secs = in_turns(run)
    log(f"# eval tracking suite seconds in turns {TURNS} ({SMI}): {json.dumps(secs)}")
    return secs


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
    where alpha's steps or float32 rounding explain it (hold_composite); the
    time of a request (render and JPEG encode) over 20 requests; then
    make_handler served on 127.0.0.1:0 in a thread, with /info and one
    /render checked. Launch counts are reset before the first render and
    read after the HTTP round trip. Returns them and the packed compositor
    input of the first render."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.viz.viewer import ViewerState, make_handler

    t0 = time.perf_counter()
    state = ViewerState(fit["log_dir"], device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = len(state.frames)
    views = viewer_views(n)

    _build.LAUNCHES.clear()
    stage_graphs.REPLAYS.clear()
    torch.cuda.synchronize()
    with compositor_shapes() as shapes:
        packed, errs, steps = viewer_hold(state, views)
    log(f"# viewer: {n} frames, {state.n_points} points, loaded in {load_s:.3f} s; rgb through "
        f"kernels vs plain versions (atol 1e-5 but where alpha's steps or float32 rounding "
        f"explain it), max abs err: {json.dumps(errs)}; pixels past the tolerance so "
        f"explained: {json.dumps(steps)}")

    # each view's request (render_jit, render2img's quantization, JPEG) as
    # CUDA graphs against eager
    holds = {k: graph_hold(lambda i=i, kw=kw: np.frombuffer(state.render(i, **kw), np.uint8))
             for k, (i, kw) in views.items()}
    log(f"# viewer requests as CUDA graphs vs eager (deterministic): JPEG bytes 0 apart, "
        f"equal launches; {json.dumps(holds)}")

    def requests(mode):
        times = []
        for r in range(10):
            i, kw = views[f"follow {r % n}"] if r % 2 == 0 else views["orbit"]
            t0 = time.perf_counter()
            state.render(i, **kw)
            times.append(time.perf_counter() - t0)
        return times

    turns = in_turns(requests)
    ms = {m: 1e3 * float(np.median(sum(t, []))) for m, t in turns.items()}
    log(f"# viewer ({SMI}): ms per request (render + JPEG, median of 20 in turns {TURNS}): "
        f"{json.dumps(ms)}; requests/s graphed {1e3 / ms['graphed']:.1f}, eager "
        f"{1e3 / ms['eager']:.1f}; each request (s) {json.dumps(turns)}")

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
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # the HTTP render and the timed requests replayed the viewer's graphs
    assert stage_graphs.REPLAYS.get("render", 0) >= 21, dict(stage_graphs.REPLAYS)
    assert (info["n_frames"], info["n_points"], info["width"], info["height"]) == (
        n, state.n_points, W, H) and len(info["poses"]) == n, info
    assert ctype == "image/jpeg" and Image.open(io.BytesIO(body)).size == (W, H)
    log(f"# viewer HTTP on 127.0.0.1: /info {json.dumps({k: v for k, v in info.items() if k != 'poses'})}, "
        f"/render a {len(body)}-byte JPEG of {W}x{H}; viewer launches {launches}; graph "
        f"replays {json.dumps(dict(stage_graphs.REPLAYS))}; packed compositor calls by shape "
        f"(the checked renders): {json.dumps(dict(shapes))}")
    assert launches.get("composite_fwd", 0) > 0 and launches.get("bin_tail", 0) > 0, launches
    assert set(shapes) == {"K1 K=128 F=3"}, shapes
    return {"launches": launches, "packed": packed[0], "graph_holds": holds,
            "ms_per_request": ms}


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


@contextmanager
def timed_calls(owner, name, seconds):
    """Append the seconds of each call of owner.name (the card
    synchronized) to `seconds` while the block runs."""
    fn = getattr(owner, name)

    def run(*args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return res

    with mock.patch.object(owner, name, run):
        yield seconds


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
    seeded weights at the released width), timed per directed pair; the
    outputs' schema; the occlusion on the card against the CPU; one
    directed pair on the card against the CPU at HOLD_FLOW_HW."""
    from gflow_tpu_torch.core.io import imread, load_image, read_flow
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.pipeline import prep_flow
    from gflow_tpu_torch.utils.cli import run_cli

    sd = seeded_state_dict(convert.expected_torch_keys(), seed=0, scale=GMFLOW_SCALE)
    pth = os.path.join(PREP_DIR, "gmflow_seeded.pth")
    torch.save({"model": sd}, pth)
    pair_s = []
    t0 = time.perf_counter()
    # a forward replays a CUDA graph: time the call that replays it
    with timed_calls(stage_graphs, "module_call", pair_s):
        run_cli(prep_flow.main, ["--img-dir", seq, "--checkpoint", pth])
    wall = time.perf_counter() - t0
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
    assert len(pair_s) == 6, pair_s

    h, w = HOLD_FLOW_HW
    a, b = (torch.from_numpy(load_image(os.path.join(seq, f"{t:05d}.jpg"))[:h, :w])[None]
            for t in (0, 1))
    cfg = GMFlowConfig()
    with torch.inference_mode():
        t1 = time.perf_counter()
        want = meta_model(GMFlow, cfg, sd, "cpu")(a, b)
        cpu_s = time.perf_counter() - t1
        got = meta_model(GMFlow, cfg, sd, "cuda")(a.cuda(), b.cuda()).cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
    mean_flow = [float(np.abs(f).mean()) for f in flows.values()]
    log(f"# prep_flow ({SMI}): GMFlow {cfg} at 864x480 (854x480 padded), 3 pairs x 2 "
        f"directions, as CUDA graphs: {np.mean(pair_s[1:]):.4f} s per directed pair (first "
        f"call, which records, {pair_s[0]:.4f} s), stage wall {wall:.2f} s; mean |flow| "
        f"{mean_flow}; occluded "
        f"share {occ_share}; occlusion card vs CPU on the same flows: {flips} pixels differ "
        f"(allowed only where |diff - bound| < {OCC_MARGIN}); one directed pair at {w}x{h} "
        f"card vs CPU max abs err {err:.3e} (atol 5e-4, rtol 1e-3; |flow| max "
        f"{float(want.abs().max()):.3f}; CPU {cpu_s:.2f} s)")
    return {"s_per_pair": float(np.mean(pair_s[1:])), "first_pair_s": pair_s[0], "wall_s": wall,
            "hold_err": err, "occ_flips": flips, "flows": flows, "sd": sd}


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
    """prep_moveseg.main on prep_flow's flows, timed per frame; its PNGs;
    epipolar_error_map card vs CPU with the same draws on a rigid scene's
    flow (a unique F: normalized maps within MAP_ATOL, at most MASK_FLIPS
    of the mask flipped), reported on prep_flow's own flows (random weights
    give flows with no epipolar structure, where the LMedS's winner is a
    near-tie); and the translation-parallax flow of tests/test_epipolar.py
    at 854x480: the block's mean error > 10x the background's."""
    from gflow_tpu_torch.core.io import imread
    from gflow_tpu_torch.pipeline import prep_moveseg
    from gflow_tpu_torch.utils.cli import run_cli

    frame_s = []
    t0 = time.perf_counter()
    with timed_calls(prep_moveseg, "epipolar_error_map", frame_s):
        run_cli(prep_moveseg.main, ["--img-dir", seq])
    wall = time.perf_counter() - t0
    moving = []
    for t in range(3):
        for tag in ("epipolar_error", "open", "erode", "dilate"):
            png = imread(os.path.join(seq + "_epipolar", f"{t:05d}_{tag}.png"))
            assert png.shape == (H, W) and png.dtype == np.uint8, (tag, png.shape)
        moving.append(float((imread(os.path.join(seq + "_epipolar", f"{t:05d}_open.png")) > 0)
                            .mean()))
    assert len(frame_s) == 3, frame_s

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
    log(f"# prep_moveseg ({SMI}): {np.mean(frame_s):.4f} s per frame (LMedS on the card as "
        f"a CUDA graph, small_eig's eigenvectors; first, which records, {frame_s[0]:.4f} s), "
        f"stage wall {wall:.2f} s; moving share after opening "
        f"{moving}; error map card vs CPU with the same draws on a rigid scene's 854x480 "
        f"flow: max abs err {err:.3e} (tol {MAP_ATOL}), mask flips {flipped:.2e} (tol {MASK_FLIPS}); "
        f"on prep_flow's first flow (reported, not held): max abs err {prep_err:.3e}, mask "
        f"flips {prep_flipped:.2e}; translation parallax: block mean {inside:.4f} vs "
        f"background {outside:.3e}")
    return {"s_per_frame": float(np.mean(frame_s)), "wall_s": wall, "map_err": err,
            "mask_flips": flipped}


def prep_depth_phase(seq):
    """prep_depth.main with MASt3R catmlp+dpt at the released width
    (seeded weights x MAST3R_SCALE) over the 4 frames: inference size 288
    (the short side, as the JAX module resizes: 512x288, 576 tokens a
    view, the size MASt3R's own loader gives 854x480 at 512), 10 directed
    pairs, the full 700-step global_align; timed per pair and per Adam
    step. The output schema; one pair on the card against the CPU; and the
    --checkpoint path with a small released-layout .pth."""
    import shutil

    from gflow_tpu_torch.core.io import _resize_hw, imread, read_camera
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, alignment, convert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.pipeline import prep_depth
    from gflow_tpu_torch.utils.cli import run_cli

    cfg = Mast3rConfig(head="catmlp+dpt")
    t0 = time.perf_counter()
    sd = seeded_state_dict(convert.expected_torch_keys(head="catmlp+dpt"), seed=0,
                           scale=MAST3R_SCALE)
    sd = {k: v for k, v in sd.items() if not k.startswith(convert._IGNORED_PREFIXES)}
    model = meta_model(Mast3rModel, cfg, sd, "cuda")
    weights_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in sd.values())
    pair_s, align, align_args = [], {}, {}

    def set_up(*args, **kw):  # prep_depth calls global_align's steps
        align_args["global_align"] = (args, kw)
        return orig_setup(*args, **kw)

    def refine_poses(setup, *args, **kw):
        res = orig_refine_poses(setup, *args, **kw, collect_timings=True)
        align.update(setup.timings)
        return res

    def refine(*args):
        align_args.setdefault("_refine", args)  # the first stage's
        return orig_refine(*args)

    orig_setup, orig_refine_poses = alignment.align_setup, alignment.refine_poses
    orig_refine = alignment._refine
    t0 = time.perf_counter()
    with timed_calls(stage_graphs, "module_call", pair_s), \
            mock.patch.object(alignment, "align_setup", set_up), \
            mock.patch.object(alignment, "refine_poses", refine_poses), \
            mock.patch.object(alignment, "_refine", refine):
        prep_depth.main(seq, inference_size=MAST3R_SIZE, model=model)
    wall = time.perf_counter() - t0
    assert len(pair_s) == 10, pair_s

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
    from gflow_tpu_torch.core.io import load_image

    a, b = (torch.from_numpy(load_image(os.path.join(seq, f"{n}.jpg"), resize=MAST3R_SIZE))[None]
            for n in names[:2])
    assert a.shape[1:3] == inf_hw, a.shape
    with torch.inference_mode(), uncounted():
        got = model(a.cuda(), b.cuda())
        cpu_model = meta_model(Mast3rModel, cfg, sd, "cpu")
        t1 = time.perf_counter()
        want = cpu_model(a, b)
        cpu_s = time.perf_counter() - t1
    del cpu_model
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

    log(f"# prep_depth ({SMI}): MASt3R catmlp+dpt ViT-L 1024x24 / ViT-B 768x12, "
        f"{n_params / 1e6:.1f}M parameters (seeded, x{MAST3R_SCALE}; built in {weights_s:.2f} s), "
        f"{inf_hw[1]}x{inf_hw[0]} ({-(-inf_hw[0] // 16) * -(-inf_hw[1] // 16)} tokens a view): "
        f"{np.mean(pair_s[1:]):.4f} s per directed pair as CUDA graphs (first, which records, "
        f"{pair_s[0]:.4f} s), 10 pairs; global_align (700 Adam steps, CUDA graphs of "
        f"{alignment.CHUNK}) "
        f"{json.dumps(align)}; stage wall {wall:.2f} s; focal {focal:.2f}; one pair card vs "
        f"CPU max abs err {json.dumps(errs)} (atol 1e-3, rtol 1e-3; CPU {cpu_s:.2f} s); "
        f"--checkpoint (small linear .pth, 3 frames) ran")
    return {"s_per_pair": float(np.mean(pair_s[1:])), "first_pair_s": pair_s[0],
            "align": align, "wall_s": wall, "hold_err": errs, "model": model,
            "align_args": align_args}


@contextmanager
def uncounted():
    """Keep the kernel launches of the block out of LAUNCHES: a hold of a
    kernel against its plain version, whose launches are no part of the
    path's count (they go to a recording's log, as a capture's do)."""
    from gflow_tpu_torch.ops import _build

    with _build.recording():
        yield


PREP_CACHES = (("gflow_tpu_torch.pipeline.prep_flow", "FLOW_GRAPHS"),
               ("gflow_tpu_torch.pipeline.prep_depth", "DEPTH_GRAPHS"),
               ("gflow_tpu_torch.ops.epipolar", "LMEDS_GRAPHS"),
               ("gflow_tpu_torch.models.mast3r.alignment", "REFINE_GRAPHS"))


@contextmanager
def fresh_prep_caches():
    """Empty graph caches of prep's compiled paths in place of the
    process's while the block runs (a hold's capture then happens inside
    the hold); yields {attr: cache}."""
    import importlib

    from gflow_tpu_torch.opt import graphs as stage_graphs

    fresh = {}
    with contextlib.ExitStack() as stack:
        for module, attr in PREP_CACHES:
            mod = importlib.import_module(module)
            old = getattr(mod, attr)
            fresh[attr] = (stage_graphs.ForwardCache(old.name, old.maxsize)
                           if isinstance(old, stage_graphs.ForwardCache)
                           else stage_graphs.GraphCache(old.maxsize))
            stack.enter_context(mock.patch.object(mod, attr, fresh[attr]))
        yield fresh


def pool_bytes(pool) -> int:
    """Bytes the allocator holds in graph memory pool `pool` (its
    segments in torch.cuda.memory_snapshot())."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def prep_graph_report(caches):
    """Per cache of prep's compiled paths: its graphs (name, nodes by
    cuGraphGetNodes, capture and instantiate seconds) and the bytes of
    its graph pools."""
    import ctypes

    from gflow_tpu_torch.opt import graphs as stage_graphs

    cuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    for attr, cache in caches.items():
        rows, pools = [], set()
        for entry in cache.entries.values():
            for name, g in entry.graphs.items():
                n = ctypes.c_size_t(0)
                rc = cuda.cuGraphGetNodes(ctypes.c_void_p(g.graph.raw_cuda_graph()), None,
                                          ctypes.byref(n))
                assert rc == 0, f"cuGraphGetNodes failed: CUresult {rc}"
                rows.append({"graph": name, "nodes": n.value, "capture_s": g.capture_s,
                             "instantiate_s": g.instantiate_s})
                pools.add(tuple(g.graph.pool()))
        if isinstance(cache, stage_graphs.ForwardCache):
            pools = {tuple(k.pool()) for k in cache.pools.values()}
        out[attr] = {"graphs": rows, "pool_bytes": sum(pool_bytes(p) for p in pools)}
    return out


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


def small_eig_rows():
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
    with uncounted():
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
            log(f"# small_eig {where} ({A.shape[0]} matrices; sign-aligned max abs err "
                f"against eigh's eigenvector): {json.dumps(rows[where])}")
    return rows


def lmeds_plain_hold():
    """The LMedS's error map on the rigid scene's 854x480 flow with
    small_eig (graphed) against the plain torch.linalg path on the card
    (eager: eigh reads back), the same draws: normalized maps within
    MAP_ATOL, at most MASK_FLIPS of the mask flipped."""
    from gflow_tpu_torch.ops import epipolar
    from gflow_tpu_torch.opt.graphs import disable_graphs
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map

    _, _, draws, flow = rigid_lmeds_inputs()
    with uncounted():
        got = epipolar_error_map(flow, device="cuda", draws=draws)
        with disable_graphs(), mock.patch.object(epipolar, "smallest_eigvec",
                                                 epipolar.smallest_eigvec_plain):
            want = epipolar_error_map(flow, device="cuda", draws=draws)
    err = float(np.abs(got - want).max())
    flips = float(((got > 0.01) != (want > 0.01)).mean())
    assert err <= MAP_ATOL and flips <= MASK_FLIPS, (err, flips)
    return {"map_err": err, "mask_flips": flips}


def prep_frames(seq, size=None, pad=1):
    """Frames 0 and 1 of `seq` on the card as (1, H, W, 3), resized to
    `size` (short side) and zero-padded to a multiple of `pad` as
    prep_flow pads them."""
    from gflow_tpu_torch.core.io import load_image

    out = []
    for t in (0, 1):
        img = load_image(os.path.join(seq, f"{t:05d}.jpg"), resize=size)
        img = np.pad(img, ((0, -img.shape[0] % pad), (0, -img.shape[1] % pad), (0, 0)))
        out.append(torch.from_numpy(img).cuda()[None])
    return out


def prep_graph_holds(seq, flow_sd, mast3r, align_args):
    """Each of prep's compiled paths as CUDA graphs against the same call
    eager (graph_hold: deterministic, 0 apart, equal launches): the
    700-step global_align of prep_depth's run (poses, depths, final loss);
    recorded anew under sync_check("error") in empty caches: the
    refinement's steps (45 steps of its first stage: two chunk graphs and
    a tail), one GMFlow directed pair at 864x480, one MASt3R pair at
    512x288, the LMedS on the rigid scene's flow, and the B-frame step
    (dryrun_step's inputs over a (2 data x 2 tile) mesh on card_list(4))
    called twice. Reports their graphs, nodes, capture and instantiate
    seconds and pool bytes."""
    from gflow_tpu_torch.models.mast3r import alignment
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
    from gflow_tpu_torch.ops import epipolar
    from gflow_tpu_torch.parallel.mesh import make_mesh
    from gflow_tpu_torch.parallel.multichip import sharded_train_step, step_inputs
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow

    holds = {}
    args, kw = align_args["global_align"]
    holds["global_align 700 steps"] = graph_hold(lambda: alignment.global_align(*args, **kw))
    gmflow = meta_model(GMFlow, GMFlowConfig(), flow_sd, "cuda")
    fa, fb = prep_frames(seq, pad=32)
    ma, mb = prep_frames(seq, size=MAST3R_SIZE)
    x1, x2, draws, _ = rigid_lmeds_inputs()
    mesh = make_mesh(4, data_parallel=2, device=list(card_list(4)))
    cfg, dyn, step_args = step_inputs(mesh)
    step = sharded_train_step(mesh, cfg, dyn)[0]

    def two_steps():
        p, o, *rest = step_args
        outs = []
        for _ in range(2):
            p, o, loss, rgb = step(p, o, *rest)
            outs.append((p, o.m, o.v, loss, rgb))
        return outs

    refine = align_args["_refine"]
    with fresh_prep_caches() as caches:
        holds["_refine 45 steps"] = graph_hold(
            lambda: alignment._refine(*refine[:9], 45), checked=True)
        with torch.inference_mode():
            holds["gmflow pair 864x480"] = graph_hold(lambda: prep_flow.batch_runner(
                gmflow, 0, fa.device, prep_flow.FLOW_GRAPHS)[0](fa, fb), checked=True)
            holds["mast3r pair 512x288"] = graph_hold(lambda: prep_flow.batch_runner(
                mast3r, 0, ma.device, prep_depth.DEPTH_GRAPHS)[0](ma, mb), checked=True)
        holds["lmeds 854x480"] = graph_hold(
            lambda: epipolar.find_fundamental_lmeds(x1, x2, draws=draws), checked=True)
        holds["b-frame step x2"] = graph_hold(two_steps, checked=True)
        torch.cuda.synchronize()
        report = prep_graph_report(caches)
    assert holds["lmeds 854x480"]["launches"] == {"small_eig": 4}, holds["lmeds 854x480"]
    log(f"# prep's compiled paths graphed vs eager ({SMI}; deterministic, 0 apart, equal "
        f"launches; all but global_align recorded under sync_check('error')): "
        f"{json.dumps(holds)}")
    log(f"# prep graphs recorded ({SMI}): {json.dumps(report)}")
    return {"holds": holds, "graphs": report}


def prep_turns(seq, flow_sd, mast3r):
    """prep_flow, prep_moveseg and prep_depth (the prep phase's models, a
    copy of its frames each run) in TURNS, graphed and eager, their graphs
    recorded before: each stage's wall seconds, GMFlow's and
    MASt3R's seconds per pair, the LMedS's ms and moveseg's seconds per
    frame, global_align's ms per Adam step and seconds per stage; and the
    B-frame step's ms (median of 10, synchronized) at the fit's width:
    bench.py's frame size, capacity and M / K (854x480, 51,200, 8 / 96) and
    the scene's focal length (500 px), 2 frames over a (2 data x 2 tile)
    mesh on card_list(4)."""
    import shutil

    from gflow_tpu_torch.models.mast3r import alignment
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.parallel.mesh import make_mesh
    from gflow_tpu_torch.parallel.multichip import sharded_train_step, step_inputs
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow, prep_moveseg

    refine_poses = alignment.refine_poses
    gmflow = meta_model(GMFlow, GMFlowConfig(), flow_sd, "cuda")
    mesh = make_mesh(4, data_parallel=2, device=list(card_list(4)))
    cfg, dyn, step_args = step_inputs(mesh, W=W, H=H, capacity=CAPACITY, max_per_tile=96,
                                      max_tiles_per_gaussian=8, focal=500.0)
    step = sharded_train_step(mesh, cfg, dyn)[0], step_args
    root = os.path.join(PREP_DIR, "turns")
    runs = iter(range(1, 100))

    def run(mode):
        d = copy_frames(seq, os.path.join(root, f"{next(runs)}_{mode}", "seq"), 4)
        pairs, frames, lmeds, align = [], [], [], {}

        def timed_refine(setup, *a, **kw):
            res = refine_poses(setup, *a, **kw, collect_timings=True)
            align.update(setup.timings)
            return res

        walls = {}
        with contextlib.redirect_stdout(io.StringIO()), \
                timed_calls(stage_graphs, "module_call", pairs), \
                timed_calls(prep_moveseg, "epipolar_error_map", frames), \
                timed_calls(prep_moveseg, "find_fundamental_lmeds", lmeds), \
                mock.patch.object(alignment, "refine_poses", timed_refine):
            for name, call in (("prep_flow", lambda: prep_flow.main(d, model=gmflow)),
                               ("prep_moveseg", lambda: prep_moveseg.main(d)),
                               ("prep_depth", lambda: prep_depth.main(
                                   d, model=mast3r, inference_size=MAST3R_SIZE))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
        shutil.rmtree(os.path.dirname(d))
        torch.cuda.synchronize()
        t_step = []
        for _ in range(10):
            t0 = time.perf_counter()
            step[0](*step[1])
            torch.cuda.synchronize()
            t_step.append(time.perf_counter() - t0)
        return {"wall_s": walls, "gmflow_s_per_pair": float(np.mean(pairs[:6])),
                "mast3r_s_per_pair": float(np.mean(pairs[6:])),
                "lmeds_ms": 1e3 * float(np.mean(lmeds)),
                "moveseg_s_per_frame": float(np.mean(frames)),
                "align_ms_per_step": align["ms_per_step"],
                "align_stage_s": align["refine_stage_secs"],
                "b_frame_step_ms": 1e3 * float(np.median(t_step))}

    # record the turns' GMFlow and B-frame step graphs (their model and
    # shapes are new; the other graphs are the prep phase's own)
    with torch.inference_mode():
        prep_flow.batch_runner(gmflow, 0, torch.device("cuda"), prep_flow.FLOW_GRAPHS)[0](
            *prep_frames(seq, pad=32))
    loss = step[0](*step[1])[2]
    assert bool(torch.isfinite(loss)), "the B-frame step at the fit's width: non-finite loss"
    turns = in_turns(run)
    log(f"# prep in turns {TURNS} ({SMI}): {json.dumps(turns)}")
    return turns


def prep_phase():
    """The prior preparation on the card, as a user runs it before a fit:
    prep_flow, prep_moveseg (on prep_flow's flows) and prep_depth on a
    4-frame 854x480 sequence, at the released model widths, every compiled
    path as CUDA graphs, with the launch counts reset just before and read
    just after: the prep path runs none of K1-K4 and small_eig in each
    LMedS. Then small_eig against its plain version, each compiled path
    graphed against eager, and the timings in turns."""
    from gflow_tpu_torch.ops import _build

    seq = prep_sequence()
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = prep_flow_phase(seq)
    moveseg = prep_moveseg_phase(seq, flow.pop("flows"))
    depth = prep_depth_phase(seq)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert not any(v for k, v in launches.items() if k != "small_eig"), launches
    assert launches.get("small_eig", 0) == 4 * 3, f"the prep path launched {launches}"
    wall = time.perf_counter() - t0
    eig = small_eig_rows()
    eig["lmeds"] = lmeds_plain_hold()
    sd, mast3r = flow.pop("sd"), depth.pop("model")
    graphed = prep_graph_holds(seq, sd, mast3r, depth.pop("align_args"))
    turns = prep_turns(seq, sd, mast3r)
    log(f"# prep ({SMI}): wall {wall:.2f} s (the holds included), then "
        f"{time.perf_counter() - t0 - wall:.2f} s of kernel holds, graph holds and turns; "
        f"launches {launches}; small_eig through the LMedS against the plain eigh path "
        f"{json.dumps(eig['lmeds'])}")
    # the models stay for the multi-GPU phase's mesh_devices holds
    return {"launches": launches, "flow": flow, "moveseg": moveseg, "depth": depth, "seq": seq,
            "models": (sd, mast3r), "small_eig": eig, "graphed": graphed, "turns": turns}


# ---------------------------------------------------------------------------
# multi-GPU: the tile-band fitting mode, the scene sweep, sharded prep
# ---------------------------------------------------------------------------

MULTI_DIR = os.path.join(FIT_DIR, "multi")
N_BANDS = 4
# banded against unbanded check_run, both deterministic: a band composites
# its tiles in place (row0) with the same kernels, so the two runs do the
# same arithmetic (0 apart on NVIDIA H100 80GB HBM3 cards at 700 W); held
# to float32 noise
BAND_LOSS_RTOL = 1e-6
BAND_PARAM_ATOL = 1e-6


def card_list(n):
    """n devices over the visible cards, round robin: with one card every
    entry is cuda:0."""
    return tuple(torch.device("cuda", i % torch.cuda.device_count()) for i in range(n))


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
    forward, K3 backward, one band per entry of `bands`): each band's call
    against the plain band version (hold_renders), and the whole against
    the unbanded kernel call on the same input (hold_composite; gradients
    normalized by max |ref| per column, 5e-4, as bwd_row). Returns errors
    and times (host-inclusive, cuda_ms: one eager call each)."""
    from gflow_tpu_torch.ops import _build, cuda_raster

    attrs_p, counts_p, g_p, rows_per = padded_block(rec, len(bands))
    T, cov, bg, n_tx = rec["attrs"].shape[0], rec["with_cov"], rec["bg"], rec["n_tx"]

    def banded():
        a = attrs_p.detach().requires_grad_()
        res = cuda_raster.band_composite(a, counts_p, bg, n_tx, rows_per, bands, cov)
        out = res[0] if cov else res
        return {"out": out.detach(), "cov": res[1] if cov else None,
                "grad": torch.autograd.grad(out, a, g_p)[0]}

    def whole():
        a = rec["attrs"].detach().requires_grad_()
        res = cuda_raster.packed_composite(a, rec["counts"], bg, n_tx, cov)
        out = res[0] if cov else res
        return {"out": out.detach(), "cov": res[1] if cov else None,
                "grad": torch.autograd.grad(out, a, rec["g"])[0]}

    before = dict(_build.LAUNCHES)
    got = banded()
    torch.cuda.synchronize()
    fwd = "composite_fwd_cov" if cov else "composite_fwd"
    delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    assert delta.get(fwd) == len(bands) and delta.get("composite_bwd") == len(bands), delta
    _, plain, calls, steps = hold_renders(banded, atol=5e-4, rtol=1e-3,
                                          phase=f"multi-GPU {len(bands)} bands")
    assert len(calls) == len(bands), len(calls)
    ref = whole()

    def grad_err(g_, w_):
        scale = w_.abs().amax(dim=(0, 1)).clamp_min(1e-12)
        return float(((g_ - w_) / scale).abs().max())

    plain_grad_err = grad_err(got["grad"], plain["grad"])
    out_err, whole_steps = hold_composite(got["out"][:T], ref["out"], rec, 5e-4, 1e-3,
                                          phase=f"multi-GPU {len(bands)} bands",
                                          view="banded vs unbanded")
    whole_grad_err = grad_err(got["grad"][:T], ref["grad"])
    assert plain_grad_err <= 5e-4 and whole_grad_err <= 5e-4, (plain_grad_err, whole_grad_err)
    assert not got["grad"][T:].any(), "padding tiles got a gradient"
    if cov:
        torch.testing.assert_close(got["cov"][:T], ref["cov"], atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(got["cov"], plain["cov"], atol=5e-4, rtol=1e-3)
    return {"bands": len(bands), "rows_per_band": rows_per, "out_err_vs_unbanded": out_err,
            "grad_err_vs_unbanded": whole_grad_err, "grad_err_vs_plain": plain_grad_err,
            "steps_per_band": steps, "steps_vs_unbanded": whole_steps,
            "banded_ms": cuda_ms(banded, reps=10), "unbanded_ms": cuda_ms(whole, reps=10)}


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


def stage_ms(scene, iters=20, eager=False):
    """ms per iteration of a full stage of `iters` iterations from the
    scene's init (no densify, the final forward included), after a warm-up
    stage: as CUDA graphs or, with eager, inside disable_graphs()."""
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)
    cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg)
    state = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    with stage_graphs.disable_graphs() if eager else contextlib.nullcontext():
        train_stage(params, state, tg, intr, gen, cfg, dynamics()[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_stage(params, state, tg, intr, gen, cfg, dynamics()[1])
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def banded_stages(scene, bands):
    """check_run (camera 10, full 10 with its two densifies, camera 10) with
    the stages' tile rows in bands, as CUDA graphs, against the same run
    unbanded and against the same banded run eager (disable_graphs), all
    deterministic: within BAND_LOSS_RTOL / BAND_PARAM_ATOL of unbanded, 0
    apart from eager with the same launches, and a graph replay per
    iteration (the launch counts reset just before the banded run and read
    just after); then 20 full-stage iterations timed unbanded, in N_BANDS
    bands on cuda:0 and, with more cards, in bands over them, each graphed
    and eager (in turns: each timed twice)."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs

    sb = banded_scene(scene, bands)
    with deterministic():
        traces_u, alive_u, p_u, _ = check_run(scene)
        _build.LAUNCHES.clear()
        stage_graphs.REPLAYS.clear()
        torch.cuda.synchronize()
        traces_b, alive_b, p_b, out_b = check_run(sb)
        torch.cuda.synchronize()
        launches, replays = dict(_build.LAUNCHES), dict(stage_graphs.REPLAYS)
        _build.LAUNCHES.clear()
        with stage_graphs.disable_graphs():
            traces_e, alive_e, p_e, out_e = check_run(sb)
        torch.cuda.synchronize()
        launches_e = dict(_build.LAUNCHES)
    for name in FIT_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched in the banded stages"
    assert replays.get("step") == 30, replays  # 3 stages x 10 iterations
    assert alive_b == alive_u == alive_e, (alive_b, alive_u, alive_e)
    rel = [float(((b - u).abs() / u.abs()).max()) for b, u in zip(traces_b, traces_u)]
    for b, u in zip(traces_b, traces_u):
        torch.testing.assert_close(b, u, rtol=BAND_LOSS_RTOL, atol=1e-5)
    pdiff = {k: float((getattr(p_b, k) - getattr(p_u, k)).abs().max()) for k in p_u._fields}
    assert max(pdiff.values()) <= BAND_PARAM_ATOL, pdiff
    assert all(torch.isfinite(v).all() for v in out_b.values())
    eager_diff = max(*(float((b - e).abs().max()) for b, e in zip(traces_b, traces_e)),
                     *(float((getattr(p_b, k) - getattr(p_e, k)).abs().max())
                       for k in p_b._fields),
                     *(float((out_b[k] - out_e[k]).abs().max()) for k in out_b))
    assert eager_diff == 0 and launches == launches_e, (eager_diff, launches, launches_e)

    b0 = banded_scene(scene, (torch.device("cuda", 0),) * N_BANDS)
    configs = {"unbanded graphed": (scene, False), "unbanded eager": (scene, True),
               f"{N_BANDS} bands on cuda:0, graphed": (b0, False),
               f"{N_BANDS} bands on cuda:0, eager": (b0, True)}
    if torch.cuda.device_count() > 1:
        over = f"{N_BANDS} bands over {torch.cuda.device_count()} cards"
        configs.update({f"{over}, graphed": (sb, False), f"{over}, eager": (sb, True)})
    order = [*configs, *reversed(list(configs))]
    times = {k: [] for k in configs}
    for k in order:
        scene_k, eager = configs[k]
        times[k].append(stage_ms(scene_k, eager=eager))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    log(f"# banded stages ({[str(d) for d in bands]}) as CUDA graphs: launches {launches}, "
        f"graph replays {replays}; n_alive {alive_b} (= unbanded); loss traces vs unbanded max "
        f"rel diff per stage {rel} (rtol {BAND_LOSS_RTOL}); params max abs diff "
        f"{json.dumps(pdiff)} (tol {BAND_PARAM_ATOL}); vs the banded run eager: max abs diff "
        f"{eager_diff}, launches equal; full stage ms/iter ({SMI}, 20 iterations, each config "
        f"twice in turns): {json.dumps(times)}")
    return {"launches": launches, "replays": replays, "loss_rel": rel, "param_max_diff": pdiff,
            "eager_max_diff": eager_diff, "ms_per_iter": ms}


def fit_multi_hold(fit, devices=None):
    """fit_scenes over one copy of the fit_video phase's sequence per entry
    of `devices` (default card_list(max(2, cards)): two workers on cuda:0
    with one card), one spawned worker each, at the fit_video phase's
    depth: each scene's checkpoints and its final frame's PSNR (the final
    checkpoint rendered by a trainer) above PSNR_FLOOR; wall seconds and
    scenes per minute."""
    import shutil

    from gflow_tpu_torch.core.io import load_image
    from gflow_tpu_torch.parallel.scene_sweep import fit_scenes
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

    devices = [str(d) for d in (devices or card_list(max(2, torch.cuda.device_count())))]
    n = len(devices)
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    seqs = [write_sequence(os.path.join(MULTI_DIR, f"scene{i}")) for i in range(n)]
    t0 = time.perf_counter()
    res = fit_scenes(seqs, fit_kwargs=FIT, devices=devices)
    wall = time.perf_counter() - t0
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
    log(f"# fit_multi ({SMI}): {n} scenes over {devices} in spawned workers: wall {wall:.2f} s, "
        f"{n / wall * 60:.2f} scenes per minute; final frame PSNR {psnr} (floor {PSNR_FLOOR})")
    return {"scenes": n, "devices": devices, "wall_s": wall, "scenes_per_min": n / wall * 60,
            "psnr": psnr}


def copy_frames(seq, dest, n):
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


def prep_mesh_hold(prep):
    """prep_flow (GMFlow at the released width, the prep phase's seeded
    weights) on the prep phase's 4 frames and prep_depth (its MASt3R) on 3
    of them, each with mesh_devices=2 against mesh_devices=0: flows within
    2e-4, depth within 2e-3 (tests/test_sharded_infer.py:52, 83)."""
    from gflow_tpu_torch.core.io import read_flow
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow

    seq, (sd, mast3r) = prep["seq"], prep.pop("models")
    root = os.path.join(MULTI_DIR, "prep")
    gmflow = meta_model(GMFlow, GMFlowConfig(), sd, "cuda")
    runs, secs = {}, {}
    with mesh_over_cards():
        for m in (0, 2):
            d = copy_frames(seq, os.path.join(root, f"flow{m}", "seq"), 4)
            t0 = time.perf_counter()
            prep_flow.main(d, model=gmflow, mesh_devices=m)
            secs[f"flow mesh {m}"] = time.perf_counter() - t0
            runs[("flow", m)] = d + "_flow_unimatch"
            d = copy_frames(seq, os.path.join(root, f"depth{m}", "seq"), 3)
            t0 = time.perf_counter()
            prep_depth.main(d, model=mast3r, inference_size=MAST3R_SIZE, mesh_devices=m)
            secs[f"depth mesh {m}"] = time.perf_counter() - t0
            runs[("depth", m)] = d + "_depth_mast3r_s2"
    flow_err = max(float(np.abs(read_flow(os.path.join(runs[("flow", 2)], f)) - read_flow(
        os.path.join(runs[("flow", 0)], f))).max()) for f in sorted(os.listdir(runs[("flow", 0)]))
        if f.endswith(".flo"))
    depth_err = max(float(np.abs(np.load(os.path.join(runs[("depth", 2)], f)) - np.load(
        os.path.join(runs[("depth", 0)], f))).max()) for f in sorted(os.listdir(
            runs[("depth", 0)])) if f.endswith(".npy"))
    assert flow_err <= 2e-4 and depth_err <= 2e-3, (flow_err, depth_err)
    replicas = None
    if torch.cuda.device_count() > 1:
        # one graph per replica on its own card, against the replicas eager
        from gflow_tpu_torch.opt.graphs import ForwardCache
        from gflow_tpu_torch.parallel.mesh import make_mesh, sharded_batch_apply

        fa, fb = prep_frames(seq, pad=32)
        run = sharded_batch_apply(gmflow, make_mesh(2, data_parallel=2, device="cuda"),
                                  ForwardCache("gmflow replicas", 4))
        with torch.inference_mode():
            replicas = graph_hold(lambda: run(torch.cat([fa, fb]), torch.cat([fb, fa])))
        assert replicas["replays"] == {"gmflow replicas": 2}, replicas
    del gmflow, mast3r
    log(f"# prep mesh_devices=2 vs 0 over {[str(d) for d in card_list(2)]} ({SMI}): flows max "
        f"abs diff {flow_err:.3e} (tol 2e-4), depth {depth_err:.3e} (tol 2e-3); seconds "
        f"{json.dumps(secs)}; GMFlow's replicas over cuda:0 and cuda:1 graphed vs eager "
        f"(0 apart): {json.dumps(replicas) if replicas else 'one card: not run'}")
    return {"flow_err": flow_err, "depth_err": depth_err, "seconds": secs,
            "replicas_graph_hold": replicas}


def shard_fit_video():
    """With two or more cards: fit_video(shard_devices=count) at the cut
    depth end to end, every stage banded over the cards, as CUDA graphs
    (its stages and renders replaying graphs that span the cards) and
    eager (disable_graphs), each on a sequence of its own."""
    from gflow_tpu_torch.ops import _build
    from gflow_tpu_torch.opt import graphs as stage_graphs

    count = torch.cuda.device_count()
    runs = {}
    for mode in ("graphed", "eager"):
        _build.LAUNCHES.clear()
        stage_graphs.REPLAYS.clear()
        with stage_graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            trainer, _, wall = run_fit_video(os.path.join(MULTI_DIR, f"shard_{mode}"), None,
                                             shard_devices=count)
        torch.cuda.synchronize()
        launches, replays = dict(_build.LAUNCHES), dict(stage_graphs.REPLAYS)
        assert trainer.render_config.band_devices == card_list(count), trainer.render_config
        assert (replays.get("step", 0) > 0) == (mode == "graphed"), (mode, replays)
        psnr, fill = fit_video_outputs(trainer)
        assert psnr > PSNR_FLOOR and fill > 50, (psnr, fill)
        summary = trainer.telemetry.summary()
        runs[mode] = {"s_per_frame": summary["sec_per_frame"], "wall_s": wall, "psnr": psnr,
                      "launches": launches, "replays": replays}
        log(f"# fit_video shard_devices={count}, {mode} ({SMI}): {summary['sec_per_frame']} "
            f"s/frame over {summary['frames']} frames, wall {wall:.2f} s; PSNR {psnr:.3f} dB; "
            f"launches {launches}; graph replays {json.dumps(replays)}")
    return runs


def multigpu_phase(scene, inputs, fit, prep):
    """The multi-GPU modes on the visible cards (band b on cuda:(b mod
    count)): (a) the band compositor on the main path's packed input, (b)
    the camera and full stages banded against unbanded, and their ms/iter,
    (c) fit_multi, (d) prep with mesh_devices=2 against 0 and, with two or
    more cards, (e) fit_video(shard_devices=count)."""
    t0 = time.perf_counter()
    bands = card_list(N_BANDS)
    log(f"# multi-GPU phase: {torch.cuda.device_count()} visible cards; {N_BANDS} bands on "
        f"{[str(d) for d in bands]}")
    a = {}
    for stage, rec in inputs[96].items():
        a[stage] = band_hold(rec, bands)
        log(f"# band compositor, main path {stage} stage input (K=96, {N_BANDS} bands): "
            f"{json.dumps(a[stage])}")
    b = banded_stages(scene, bands)
    c = fit_multi_hold(fit)
    d = prep_mesh_hold(prep)
    e = shard_fit_video() if torch.cuda.device_count() > 1 else None
    wall = time.perf_counter() - t0
    log(f"# multi-GPU phase wall {wall:.1f} s")
    return {"band_compositor": a, "stages": b, "fit_multi": c, "prep": d, "shard_fit_video": e,
            "launches": b["launches"], "wall_s": wall}


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


def graph_report(trainer):
    """Every CUDA graph recorded by the stages called from this script
    (opt.graphs.DEFAULT_CACHE), by the host-called renders (ops.render's
    caches: the viewer's, render_views', the quantization's) and by the
    fit_video phase's trainer (its stages and its forward caches): its
    cache and key (a stage's iterations and path; a forward call's static
    arguments and first input's shape), nodes (cuGraphGetNodes on the kept
    graph), seconds of capture and of instantiation, kernel launches per
    replay."""
    import ctypes

    from gflow_tpu_torch.ops import render
    from gflow_tpu_torch.opt import graphs as stage_graphs

    cuda = ctypes.CDLL("libcuda.so.1")
    caches = {"stages": stage_graphs.DEFAULT_CACHE, "fit_video stages": trainer.graphs,
              **{c.name: c for c in (render.RENDER_GRAPHS, render.RENDER_TRAJ_GRAPHS,
                                     render.QUANTIZE_GRAPHS)},
              **{f"fit_video {k}": c for k, c in trainer.forward_graphs.items()}}
    rows = []
    for cache_name, cache in caches.items():
        for key, entry in cache.entries.items():
            if isinstance(cache, stage_graphs.ForwardCache):
                static, names, shapes, _, ctx = key
                what = {"static": repr(static)[:80],
                        "input": f"{names[0]} {str(shapes[0])[:40]}"}
            else:
                cfg, ctx = key[0], key[-1]
                path = ("camera" if cfg.camera_only else "snapshot" if cfg.snapshot_every
                        else "rebin" if cfg.rebin_every > 1 else "lean")
                what = {"stage": f"{path} {cfg.iterations} it K={cfg.render.max_per_tile}"
                                 f"{' banded' if cfg.render.band_devices else ''}"}
            for name, g in entry.graphs.items():
                n = ctypes.c_size_t(0)
                rc = cuda.cuGraphGetNodes(ctypes.c_void_p(g.graph.raw_cuda_graph()), None,
                                          ctypes.byref(n))
                assert rc == 0, f"cuGraphGetNodes failed: CUresult {rc}"
                rows.append({"cache": cache_name, **what, "compositor": ctx[0].__name__,
                             "deterministic": ctx[-2], "graph": name, "nodes": n.value,
                             "capture_s": g.capture_s, "instantiate_s": g.instantiate_s,
                             "launches": len(g.launches)})
    log(f"# CUDA graphs recorded ({len(rows)}): {json.dumps(rows)}")
    return rows


def profile_iterations(scene, iters=10):
    """Where an iteration's time goes: a full stage of `iters` iterations
    (no densify, the final forward included) from the scene's init, as
    CUDA graphs and eager, each run once unprofiled for its wall time and
    once under torch.profiler for its device time (after a warm-up stage
    that records the graphs). Device busy time is the sum of the device
    kernels' times; the profiler slows the host, so the idle share is taken
    against the unprofiled run of the same stage. Graph launches per
    iteration: the replays the stage made (opt.graphs.REPLAYS) over
    `iters`."""
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage
    from gflow_tpu_torch.utils.profiling import trace

    img, depth, intr, params, n0, rcfg = scene
    tg = targets(img, depth)
    _, dyn_full = dynamics()
    cfg = StageConfig(W=W, H=H, iterations=iters, render=rcfg)
    state = init_frame_state(CAPACITY)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for mode in ("graphed", "eager"):
        with stage_graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            train_stage(params, state, tg, intr, gen, cfg, dyn_full)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_stage(params, state, tg, intr, gen, cfg, dyn_full)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            trace_dir = os.path.join(FIT_DIR, "profile", mode)
            stage_graphs.REPLAYS.clear()
            with trace(trace_dir) as prof:
                t0 = time.perf_counter()
                train_stage(params, state, tg, intr, gen, cfg, dyn_full)
                torch.cuda.synchronize()
                profiled_wall_ms = (time.perf_counter() - t0) * 1e3
            replays = sum(stage_graphs.REPLAYS.values())
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3 / iters
        top = [{"name": k[:70], "ms_per_iter": us / 1e3 / iters, "calls_per_iter": c / iters}
               for us, c, k in sorted(rows, reverse=True)[:12]]
        wall = wall_ms / iters
        summary = {"iters": iters, "profiled_wall_ms_per_iter": profiled_wall_ms / iters,
                   "wall_ms_per_iter": wall,
                   "device_busy_ms_per_iter": busy if rows else "not measured",
                   "device_idle_share": 1.0 - busy / wall if rows else "not measured",
                   "device_kernels_per_iter": sum(r[1] for r in rows) / iters
                   if rows else "not measured",
                   "graph_launches_per_iter": replays / iters, "top": top,
                   "chrome_trace": os.path.relpath(os.path.join(trace_dir, "trace.json"))}
        log(f"# profile ({mode} full stage, final forward included): {json.dumps(summary)}")
        out[mode] = summary
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from gflow_tpu_torch.ops import _build

    global SMI
    smi = SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    log(smi)
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
    inputs = timed("main path inputs", main_path_inputs, scene)
    rows = timed("kernels", kernel_phase, inputs)
    ssim = timed("ssim", ssim_rows)
    sam, sam_decode = timed("sam decoder", sam_decoder_rows)
    launches, replayed, stamps = timed("main path", main_path, scene)
    fit = timed("fit_video", fit_video_phase, scene)
    ev = timed("eval", eval_phase, fit)
    viewer = timed("viewer", viewer_phase, fit)
    prep = timed("prep", prep_phase)
    multi = timed("multi-GPU", multigpu_phase, scene, inputs, fit, prep)
    # K1 at K = 128 on the eval's (F = 2) and the viewer's (F = 3) own packed
    # input, K4 on the eval's two-class stream
    for where, rec in (("eval F=2", ev["packed"]), ("viewer F=3", viewer["packed"])):
        rows[("composite_fwd", 128, where)] = fwd_row(rec["attrs"], rec["counts"], rec["bg"],
                                                     rec["n_tx"], False, where)
    rows[("bin_tail", 128, "eval two-class")] = tail_row(ev["stream"], 128, "eval two-class")
    for (name, k, where), r in rows.items():
        if k == 128:
            log_row(name, k, where, r)
    frame = timed("canonical frame", time_frame, scene)
    for mode in ("graphed", "eager"):
        m = frame[f"{mode}_mean"]
        log(f"# canonical frame (150 camera + 300 full iterations), {mode}, {smi}, one "
            f"frame after a graphed warm-up frame: camera {m['cam_ms_per_iter']:.3f} ms/iter, full "
            f"{m['full_ms_per_iter']:.3f} ms/iter, {m['s_per_frame']:.3f} s/frame")
    timed("profile", profile_iterations, scene)
    graph_report(fit["trainer"])
    timed("binning profile", profile_binning, inputs)

    replaces = {"composite_fwd": "gflow_tpu/ops/pallas_raster.py:127",
                "composite_fwd_cov": "gflow_tpu/ops/pallas_raster.py:127",
                "composite_bwd": "gflow_tpu/ops/pallas_raster.py:172",
                "bin_tail": "gflow_tpu/ops/binning.py:293"}
    kernels = []
    for name in FIT_KERNELS:
        src = _build.KERNELS[name][0]
        r = rows[(name, 96, "synthetic")]
        row = {"name": name, "route": "cuda", "source": f"gflow_tpu_torch/csrc/{src}",
               "replaces": replaces[name],
               "launches": launches[name], "graph_replay_launches": replayed[name],
               "fit_video_launches": fit["launches"][name],
               "eval_launches": ev["launches"].get(name, 0),
               "viewer_launches": viewer["launches"].get(name, 0),
               "prep_launches": prep["launches"].get(name, 0),
               "multigpu_launches": multi["launches"][name],
               "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if "max_norm_err" in r:  # K3: also the error normalized by max |ref| per column
            row["max_norm_err"] = r["max_norm_err"]
        if "searchsorted_ms" in r:  # K4: the library call for its segment starts alone
            row["searchsorted_ms"] = r["searchsorted_ms"]
        # the same measurements on the main path's own input (K = 96), K4's
        # on the two-class stream, and at K = 128 on the eval's and the
        # viewer's own input
        keep = ("ms", "plain_ms", "bound_ms", "max_abs_err", "library_ms", "searchsorted_ms")
        other = {where: {k: v for k, v in rm.items() if k in keep}
                 for (n, k, where), rm in rows.items()
                 if n == name and k in (96, 128) and where != "synthetic"}
        main = {w: v for w, v in other.items() if w.startswith("main")}
        if main:
            row["main_path_input"] = main
        if "two-class" in other:
            row["two_class_input"] = other["two-class"]
        k128 = {w: v for w, v in other.items() if w.startswith(("eval", "viewer"))}
        if k128:
            row["k128_eval_viewer_input"] = k128
        kernels.append(row)
    # the port's kernel without a Pallas counterpart: the LMedS's eigensolver
    # (prep path), timed on 512 matrices of 9 x 9 of separated spectra and
    # on the LMedS's own four (512 and 1 of 9 x 9 and of 3 x 3)
    eig = prep["small_eig"]
    r = eig["synthetic 9x9"]
    kernels.append({
        "name": "small_eig", "route": "cuda", "source": "gflow_tpu_torch/csrc/small_eig.cu",
        "replaces": "gflow_tpu/ops/epipolar.py:34",
        "pallas_counterpart": None,
        "note": "no Pallas kernel: stands in for XLA's eigh and svd in the LMedS's _solve_f",
        "launches": prep["launches"]["small_eig"], "prep_launches": prep["launches"]["small_eig"],
        "main_path_launches": launches.get("small_eig", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "residual": r["residual"], "ptxas": r["ptxas"],
        "other_inputs": {w: {k: v for k, v in x.items() if k in (
            "batch", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err", "residual",
            "ptxas")} for w, x in eig.items() if w not in ("synthetic 9x9", "lmeds")},
        "lmeds_vs_plain": eig["lmeds"]})
    # the stage's timestamps, launched where a trainer has telemetry
    # (fit_video's): 5 a stamped iteration (stamp_hold)
    kernels.append({
        "name": "stamp", "route": "cuda", "source": "gflow_tpu_torch/csrc/stamp.cu",
        "replaces": None, "pallas_counterpart": None,
        "note": "no Pallas kernel: times the pieces of a graphed iteration on the card's timer",
        "launches": stamps["launches"]["stamp"],
        "main_path_launches": launches.get("stamp", 0),
        "fit_video_launches": fit["launches"].get("stamp", 0),
        "eval_launches": ev["launches"].get("stamp", 0),
        "viewer_launches": viewer["launches"].get("stamp", 0),
        "prep_launches": prep["launches"].get("stamp", 0),
        "multigpu_launches": multi["launches"].get("stamp", 0),
        "ms_per_iter": stamps["ms_per_iter"]})
    # the loss's SSIM (fit path, eval's metric): no Pallas kernel, XLA fuses
    # the JAX package's
    for name in ("ssim_fwd", "ssim_bwd"):
        kernels.append({
            "name": name, "route": "cuda", "source": "gflow_tpu_torch/csrc/ssim.cu",
            "replaces": "gflow_tpu/opt/losses.py ssim", "pallas_counterpart": None,
            "note": "no Pallas kernel: stands in for the plain version's ~90 elementwise "
                    "launches an iteration",
            "launches": launches.get(name, 0), "main_path_launches": launches.get(name, 0),
            "fit_video_launches": fit["launches"].get(name, 0),
            "eval_launches": ev["launches"].get(name, 0),
            "viewer_launches": viewer["launches"].get(name, 0),
            "prep_launches": prep["launches"].get(name, 0),
            "multigpu_launches": multi["launches"].get(name, 0), **ssim[name]})
    # the mask prior's decoder (prep_mask, not on the fit's path): no Pallas
    # kernel, SAM has no counterpart in the JAX package
    for name, r in sam.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "gflow_tpu_torch/csrc/sam_decoder.cu",
            "replaces": None, "pallas_counterpart": None,
            "note": "no Pallas kernel: the image stream of SAM's mask decoder, in place of "
                    "strided copies, broadcast adds, materialised scores and separate norms",
            "launches_per_decode": sam_decode["launches"].get(name, 0),
            "main_path_launches": launches.get(name, 0),
            "prep_launches": prep["launches"].get(name, 0), **r})
    log(f"# chip_smoke wall time {time.perf_counter() - t_start:.1f} s; by phase (s) "
        f"{json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
