"""One optimization stage of the per-frame fit (SimpleGaussian.train(),
gflow/trainer.py:332-711).

Counterpart of ``gflow_tpu/opt/train.py``: iterations of render -> loss
-> backward -> gated Adam. The loop carries its state in fixed buffers
(``_StageBuffers``), updated in place by each piece of the loop body (an
iteration, a rebinning, a snapshot); the learning rates come from a
per-stage schedule tensor and the densify uniforms are drawn up front. On a
CUDA device each piece runs as the replay of a CUDA graph recorded once per
static configuration (``opt/graphs.py``, the counterpart of the JAX
package's jitted ``fori_loop``), and densify runs eagerly between replays;
on the CPU the same pieces run eagerly. Each iteration composites one fused
rgb+depth feature pass; the camera-only stage adds the moving-Gaussian
coverage as a second output of the same compositor pass (kernel K2 on
CUDA). With ``cfg.render.band_devices`` both composite in bands of tile
rows, one per device (the tile-band fitting mode, ``parallel/mesh.py``).
Three variants, as in the JAX package:

- the lean path (``snapshot_every == 0``): densify after the iteration
  that the static schedule names, the error map from one extra forward at
  the updated parameters; then one no-grad forward for the stage's output
  render;
- amortized rebinning (``rebin_every > 1``, lean path only): the tile
  lists come from detached geometry every ``rebin_every`` iterations and
  after every densify; gradients flow through the gathered values only;
- the snapshot path (``snapshot_every > 0``): densify inside the loop from
  that iteration's own error map (taken before the Adam update, applied to
  the updated parameters); every ``snapshot_every`` iterations a uint8
  snapshot of the last forward's rgb and turbo depth and of the updated
  parameters' center view; no final forward, so the stage's outputs come
  from the last in-loop forward.

With ``cfg.stamps`` every iteration also stamps the boundaries of its
pieces into ``_StageBuffers.stamps`` (``ops/stamp.py``: the card's timer
on CUDA, recorded into the iteration's graph and replayed with it; the
host's clock on the CPU), so that the render, the losses, the backward
and the update can be timed inside a graph replay. In the tile-band mode
the stamps mark the home card's stream only.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import pix2world, pose_to_extr
from ..core.scene import OPACITY_SENSITIVITY
from ..ops.binning import TileBins, tile_grid
from ..ops.projection import TILE, project_gaussians, supported_max_radius
from ..ops.render import (DEFAULT_CONFIG, RenderConfig, bin_with, composite,
                          composite_with_coverage, render)
from ..ops.stamp import COLS as STAMP_COLS, stamp
from ..viz.colormap import apply_float_colormap
from . import graphs as stage_graphs
from .graphs import copy_into, tree_map
from .densify import densify_by_pixels, reset_opt_after_densify
from .losses import LossWeights, compute_losses, flow_prior_terms
from .state import FrameState, Params, Targets, adam_update, init_opt_state


@dataclass(frozen=True)
class StageConfig:
    W: int
    H: int
    iterations: int
    camera_only: bool = False
    propagate: bool = False        # flow warm-start of moving points (trainer.py:347-381)
    densify_interval: int = 0
    densify_times: int = 0
    densify_occ: bool = False      # iteration-0 occluded-region densify (trainer.py:562-564)
    max_densify: int = 8192
    bg: float = 0.0
    render: RenderConfig = field(default_factory=lambda: DEFAULT_CONFIG)
    snapshot_every: int = 0          # >0: the snapshot path (module docstring)
    telemetry_t_final: bool = False  # residual-transmittance stats on the final forward
    rebin_every: int = 1             # >1: amortized rebinning (module docstring)
    stamps: bool = False             # stamp each iteration's pieces (module docstring)


class StageDynamics(NamedTuple):
    lr: float = 1e-2
    lr_camera: float = 0.0
    weights: LossWeights = LossWeights()
    num_points: float = 10000     # configured base point count (densify sizing)
    densify_occ_percent: float = 1.0
    densify_err_thre: float = 1e-2
    densify_err_percent: float = 1.0


def _activate(params: Params, n_alive):
    alive = (torch.arange(params.capacity, device=params.xyz.device) < n_alive)[:, None]
    scale = torch.abs(params.scale)
    rotate = params.rotate / torch.linalg.norm(
        params.rotate, dim=-1, keepdim=True).clamp_min(1e-12)
    opacity = torch.sigmoid(params.opacity * OPACITY_SENSITIVITY) * alive
    rgb = torch.sigmoid(params.rgb)
    return scale, rotate, opacity, rgb


@torch.no_grad()
def _compute_bins(params: Params, n_alive, intr, cfg: StageConfig):
    """Tile binning from the current geometry alone (the lists are integer
    data: no gradient path either way); the rebin_every > 1 loop carries
    them between refreshes."""
    scale, rotate, _, _ = _activate(params, n_alive)
    proj = project_gaussians(
        params.xyz, scale, rotate, intr, pose_to_extr(params.pose), cfg.W, cfg.H,
        max_radius=supported_max_radius(cfg.render.max_tiles_per_gaussian))
    return bin_with(cfg.render, proj["uv"], proj["depth"], proj["radius"], cfg.W, cfg.H)


def _forward(params: Params, n_alive, state: FrameState, targets: Targets, intr,
             weights: LossWeights, cfg: StageConfig, flow_prior=None,
             diag_t_final: bool = False, bins=None, mark=None):
    """Render + losses. Returns (total, aux). bins: tile lists carried by
    the rebinning loop; None bins this forward's own projection. mark:
    mark(col) stamps the iteration's column col (``_iteration``) after
    the compositing (1) and at the forward's end (2).

    diag_t_final: append a ones feature channel whose composited value is
    the per-pixel accumulated opacity sum(alpha_i * T_i); the residual
    transmittance T_final = (1 - acc) / (1 - bg) bounds what the nearest-K
    per-tile truncation can contribute (reported on K-overflowing tiles)."""
    extr = pose_to_extr(params.pose)
    scale, rotate, opacity, rgb = _activate(params, n_alive)
    if cfg.camera_only:
        # the pose reaches the loss only through projection; opacity and rgb
        # gradients are gated off in this stage anyway
        opacity, rgb = opacity.detach(), rgb.detach()
    proj = project_gaussians(
        params.xyz, scale, rotate, intr, extr, cfg.W, cfg.H,
        max_radius=supported_max_radius(cfg.render.max_tiles_per_gaussian))
    uv, depth, conic, radius = proj["uv"], proj["depth"], proj["conic"], proj["radius"]
    n_tx, n_ty = tile_grid(cfg.W, cfg.H)
    if bins is None:
        bins = bin_with(cfg.render, uv, depth, radius, cfg.W, cfg.H)

    feat_list = [rgb, depth]  # fused rgb + depth pass
    if diag_t_final:
        feat_list.append(torch.ones_like(depth))
    feats = torch.cat(feat_list, dim=1)
    move_mask = targets.move_mask
    if cfg.camera_only:
        # augment the moving prior with the rendered coverage of last
        # frame's moving Gaussians (trainer.py:427-451)
        slot = torch.arange(params.capacity, device=uv.device)
        mov = ((slot < state.last_num) & ~state.still_mask_tentative)[:, None]
        img, cov = composite_with_coverage(
            cfg.render, bins.tile_lists, uv, conic, opacity, feats, mov.to(torch.float32),
            cfg.bg, cfg.W, cfg.H, n_tx, n_ty, tile_counts=bins.tile_counts)
        move_mask = move_mask | (cov[..., 0] > 0)
    else:
        img = composite(cfg.render, bins.tile_lists, uv, conic, opacity, feats, cfg.bg,
                        cfg.W, cfg.H, n_tx, n_ty, tile_counts=bins.tile_counts)
    if mark is not None:
        mark(1)
    rendered_rgb = img[..., :3]
    rendered_depth = img[..., 3:4]

    total, metrics, loss_rgb_pixel = compute_losses(
        rendered_rgb, rendered_depth, uv, depth, scale, params.xyz,
        params.depth_ab, targets._replace(move_mask=move_mask),
        state._replace(n_alive=n_alive), weights, cfg.camera_only, cfg.W,
        cfg.H, flow_prior=flow_prior)
    over = bins.tile_counts > cfg.render.max_per_tile
    aux = {
        "uv": uv,
        "depth": depth,
        "rgb": rendered_rgb,
        "depth_map": rendered_depth,
        "loss_rgb_pixel": loss_rgb_pixel,
        "metrics": metrics,
        # how often the nearest-K per-tile cap bites
        "tile_overflow": over.to(torch.float32).mean(),
    }
    if diag_t_final:
        acc = img[..., feats.shape[1] - 1]
        t_final = ((1.0 - acc) / max(1.0 - cfg.bg, 1e-6)).clamp(0.0, 1.0)
        overpix = over.reshape(n_ty, n_tx).repeat_interleave(TILE, 0).repeat_interleave(
            TILE, 1)[:cfg.H, :cfg.W]
        aux["t_final_overflow_mean"] = (t_final * overpix).sum() / overpix.sum().clamp_min(1)
        aux["t_final_overflow_max"] = torch.where(overpix, t_final, 0.0).max()
    if mark is not None:
        mark(2)
    return total, aux


def _gate_grads(grads: Params, state: FrameState, n_alive, camera_only: bool) -> Params:
    """Gradient control (trainer.py:535-551) + non-finite sanitization: a
    single inf gradient would permanently NaN-poison Adam's moments."""
    grads = Params(*(torch.where(torch.isfinite(g), g, 0.0) for g in grads))
    in_prev = torch.arange(grads.capacity, device=grads.xyz.device) < state.last_num
    # rgb grads zeroed for frames >= 2; still points' xyz grads zeroed
    rgb = torch.where(state.last_num > 0, 0.0, grads.rgb)
    xyz = torch.where((in_prev & state.still_mask)[:, None], 0.0, grads.xyz)
    grads = grads._replace(rgb=rgb, xyz=xyz)
    if camera_only:
        grads = grads._replace(**{k: torch.zeros_like(getattr(grads, k))
                                  for k in ("xyz", "scale", "rotate", "opacity", "rgb")})
    return grads


def propagate_moving_points(params: Params, state: FrameState, targets: Targets,
                            intr, W: int, H: int) -> Params:
    """Flow-prior warm start: overwrite moving points' xyz by unprojecting
    (last_uv + flow) at the current frame's depth (trainer.py:347-381)."""
    extr = pose_to_extr(params.pose)
    lu = state.last_uv
    in_prev = torch.arange(params.capacity, device=lu.device) < state.last_num
    moving = in_prev & ~state.still_mask
    within = (lu[:, 0] > 0) & (lu[:, 0] < W - 1) & (lu[:, 1] > 0) & (lu[:, 1] < H - 1)
    xi = lu[:, 0].to(torch.int64).clamp(0, W - 1)
    yi = lu[:, 1].to(torch.int64).clamp(0, H - 1)
    uv_new = lu + targets.flow[yi, xi]
    xi2 = uv_new[:, 0].to(torch.int64).clamp(0, W - 1)
    yi2 = uv_new[:, 1].to(torch.int64).clamp(0, H - 1)
    xyz_new = pix2world(uv_new, targets.depth[yi2, xi2, 0], intr, extr)
    return params._replace(
        xyz=torch.where((moving & within)[:, None], xyz_new, params.xyz))


def finalize_stage(uv, depth, params: Params, state: FrameState, move_mask, n_alive,
                   W: int, H: int) -> FrameState:
    """Post-update bookkeeping (trainer.py:588-625): refresh still masks from
    the final render, keep old points' assignment, cache last_*."""
    slot = torch.arange(params.capacity, device=uv.device)
    alive = slot < n_alive
    within = ((uv[:, 0] > 0) & (uv[:, 0] < W - 1) & (uv[:, 1] > 0)
              & (uv[:, 1] < H - 1) & alive)
    xi = uv[:, 0].to(torch.int64).clamp(0, W - 1)
    yi = uv[:, 1].to(torch.int64).clamp(0, H - 1)
    fresh = torch.where(within, ~move_mask[yi, xi], True)
    keep = (state.last_num > 0) & (slot < state.last_num)
    return FrameState(
        n_alive=n_alive,
        still_mask=torch.where(keep, state.still_mask, fresh),
        still_mask_tentative=fresh,
        last_uv=uv,
        last_depth=depth,
        last_xyz=params.xyz,
        last_num=n_alive,
    )


def _densify_events(cfg: StageConfig) -> list[tuple[str, int]]:
    """The static schedule (trainer.py:560-571): iteration-0 occ densify and
    error densify every densify_interval iterations; (kind, e) means
    "densify after iteration e completes"."""
    events = []
    if not cfg.camera_only:
        if cfg.densify_occ:
            events.append(("occ", 0))
        if cfg.densify_interval > 0:
            for t in range(1, cfg.densify_times + 1):
                e = cfg.densify_interval * t - 1
                if e < cfg.iterations and ("occ", e) not in events:
                    events.append(("err", e))
    return sorted(events, key=lambda kv: kv[1])


def lr_schedule(cfg: StageConfig, dyn: StageDynamics) -> torch.Tensor:
    """(iterations, 3) float32: row i holds iteration i's learning rates of
    the attribute, pose and depth groups. LinearLR 1.0 -> 0.1 over the
    stage (trainer.py:384) up to the first densify event; after it the
    constant attribute lr with pose and depth frozen (the post-densify
    quirk, opt/densify.py). The arithmetic is the reference's: the factor
    in float32, each lr times it in double, rounded to float32."""
    events = _densify_events(cfg)
    post = events[0][1] + 1 if events else cfg.iterations
    i = np.arange(cfg.iterations, dtype=np.float32)
    factor = (np.float32(1.0) - np.float32(0.9) * i / np.float32(cfg.iterations)).astype(
        np.float64)
    lr, lr_cam = float(np.float32(dyn.lr)), float(np.float32(dyn.lr_camera))
    rows = np.stack([lr * factor, lr_cam * factor, lr * factor], axis=1).astype(np.float32)
    rows[post:] = (lr, 0.0, 0.0)
    return torch.from_numpy(rows)


def densify_uniforms(gen: torch.Generator, max_densify: int, n_events: int) -> torch.Tensor:
    """(n_events, max_densify) uniforms in [0, 1) on gen's device, drawn up
    front: row k is the draw the k-th densify event takes, in event order,
    one torch.rand per event as the events would draw them."""
    draws = [torch.rand(max_densify, generator=gen, device=gen.device)
             for _ in range(n_events)]
    return torch.stack(draws) if draws else torch.empty((0, max_densify), device=gen.device)


def _same(x):
    return x


def _to(tup, dev):
    return type(tup)(*(x.to(dev) for x in tup))


class _StageBuffers:
    """Every tensor an iteration reads or writes, at addresses that stay put
    for a CUDA graph: what the loop carries (``CARRIED``: the parameters,
    Adam's moments and step, n_alive, the iteration counter ``it`` (1,)
    int64, the loss trace, when rebinning the tile lists, and with
    ``cfg.stamps`` the stamp table (iterations, ``ops.stamp.COLS``) int64)
    and the stage's inputs (frame state, targets, intrinsics, flow-prior
    terms, the lr schedule). Every piece of the loop updates them in place,
    eager or replayed."""

    CARRIED = ("params", "opt", "n_alive", "it", "losses", "bins", "stamps")

    def __init__(self, **fields):
        self.__dict__.update(fields)

    @classmethod
    def of(cls, inputs: dict, cfg: StageConfig) -> "_StageBuffers":
        """Buffers holding copies of `inputs` (train_stage's), Adam's state
        at zero, when rebinning tile lists to be filled at iteration 0, and
        with ``cfg.stamps`` the stamp table."""
        dev = inputs["intr"].device
        bins = None
        if cfg.rebin_every > 1 and cfg.snapshot_every <= 0:
            n_tx, n_ty = tile_grid(cfg.W, cfg.H)
            T = n_tx * n_ty
            bins = TileBins(
                torch.full((T, cfg.render.max_per_tile), -1, dtype=torch.int32, device=dev),
                torch.zeros(T, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        # init_opt_state's m and v are one tensor: cloned apart, since the
        # loop writes each in place
        return cls(**tree_map(torch.clone, inputs),
                   opt=tree_map(torch.clone, init_opt_state(inputs["params"])),
                   it=torch.zeros(1, dtype=torch.int64, device=dev),
                   losses=torch.zeros(cfg.iterations, device=dev), bins=bins,
                   stamps=torch.zeros((cfg.iterations, STAMP_COLS), dtype=torch.int64,
                                      device=dev) if cfg.stamps else None)

    def load(self, inputs: dict) -> None:
        """Start a stage on these buffers: the inputs copied in, Adam's
        state, the counter, the trace and the stamps at zero."""
        for k, v in inputs.items():
            copy_into(getattr(self, k), v)
        for t in (*self.opt.m, *self.opt.v, self.opt.step, self.it, self.losses, self.stamps):
            if t is not None:
                t.zero_()

    def scratch(self) -> "_StageBuffers":
        """A copy whose carried tensors are clones (a graph's warm-up)."""
        return _StageBuffers(**{k: tree_map(torch.clone, v) if k in self.CARRIED else v
                                for k, v in vars(self).items()})


def _iteration(buf: _StageBuffers, cfg: StageConfig, weights: LossWeights):
    """One iteration in place on `buf`: forward, gated gradients, Adam at
    row buf.it of the schedule, the loss into the trace, buf.it + 1; with
    stamps, row buf.it of the stamp table at the start, after the
    compositing, after the losses, after the backward and at the end.
    Returns the forward's aux outputs, detached."""
    mark = None
    if buf.stamps is not None:
        def mark(col):
            stamp(buf.it, buf.stamps, col)

        mark(0)
    leaves = [p.detach().requires_grad_() for p in buf.params]
    total, aux = _forward(Params(*leaves), buf.n_alive, buf.state, buf.targets, buf.intr,
                          weights, cfg, flow_prior=buf.flow_prior, bins=buf.bins, mark=mark)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    if mark is not None:
        mark(3)
    grads = Params(*(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)))
    grads = _gate_grads(grads, buf.state, buf.n_alive, cfg.camera_only)
    lr = buf.lrs.index_select(0, buf.it)[0]
    params, opt = adam_update(Params(*(x.detach() for x in leaves)), grads, buf.opt,
                              lr[0], lr[1], lr[2])
    copy_into(buf.params, params)
    copy_into(buf.opt, opt)
    at_i = torch.arange(cfg.iterations, device=buf.it.device) == buf.it
    buf.losses.copy_(torch.where(at_i, total.detach(), buf.losses))
    if mark is not None:
        mark(4)
    buf.it += 1
    return tree_map(torch.Tensor.detach, aux)


def _rebin(buf: _StageBuffers, cfg: StageConfig):
    """The tile lists from the current geometry, into buf.bins."""
    copy_into(buf.bins, _compute_bins(buf.params, buf.n_alive, buf.intr, cfg))
    return {}


@torch.no_grad()
def _densify(buf: _StageBuffers, cfg: StageConfig, dyn: StageDynamics, kind: str, u,
             emap=None):
    """Densify in place on `buf` with the uniforms u, then reset Adam
    (the post-densify quirk, opt/densify.py). kind "occ": uniform map over
    the occ mask; "err": the rgb error above threshold, from `emap` or,
    without one, from one extra forward at the current parameters."""
    if kind == "err":
        if emap is None:
            emap = _forward(buf.params, buf.n_alive, buf.state, buf.targets, buf.intr,
                            dyn.weights, cfg, flow_prior=buf.flow_prior)[1]["loss_rgb_pixel"]
        mask = emap > dyn.densify_err_thre
        percent = dyn.densify_err_percent
    else:
        emap = torch.ones((cfg.H, cfg.W), dtype=torch.float32, device=buf.intr.device)
        mask = buf.targets.occ_mask
        percent = dyn.densify_occ_percent
    params, n_alive, _ = densify_by_pixels(
        buf.params, buf.n_alive, emap, mask, buf.targets.image, buf.targets.depth, buf.intr,
        pose_to_extr(buf.params.pose), dyn.num_points, percent, u)
    copy_into(buf.params, params)
    buf.n_alive.copy_(n_alive)
    copy_into(buf.opt, reset_opt_after_densify(buf.opt, params))


@torch.no_grad()
def _snapshot(aux, params: Params, n_alive, intr, cfg: StageConfig, dev):
    """uint8 rgb and turbo depth of the last forward, and the center view
    (identity conic, opacity 1) of the updated parameters."""
    scale, rotate, opacity, rgb = _activate(params, n_alive)
    center = render(params.xyz, scale, rotate, opacity, rgb, intr, pose_to_extr(params.pose),
                    cfg.bg, cfg.W, cfg.H, ("center",), cfg.render, device=dev)["center"]
    u8 = lambda x: (x.clamp(0.0, 1.0) * 255).to(torch.uint8)
    return {"rgb": u8(aux["rgb"]),
            "depth_map": u8(apply_float_colormap(aux["depth_map"], "turbo", non_zero=True)),
            "center": u8(center)}


def train_stage(params: Params, state: FrameState, targets: Targets, intr,
                gen: torch.Generator, cfg: StageConfig, dyn: StageDynamics,
                device=None, graphs: stage_graphs.GraphCache | None = None):
    """Run one optimization stage on `device` (``cuda`` unless the caller
    passes another). `gen` draws the densify uniforms. On a CUDA device the
    loop runs as CUDA graphs kept in `graphs` (None: the process's
    ``opt.graphs.DEFAULT_CACHE``), over every card of the tile-band mode;
    eagerly on the CPU and inside ``opt.graphs.disable_graphs()``. Returns (params, state,
    info); info["loss_trace"] holds every iteration's total loss, on the
    snapshot path info["snapshots"] the uint8 stacks (n_chunks, H, W, 3)
    under "rgb", "depth_map" and "center", and with ``cfg.stamps``
    info["stamps"] the stamp table (``ops.stamp.pieces`` reads it)."""
    dev = resolve_device(device)
    params, state, targets = _to(params, dev), _to(state, dev), _to(targets, dev)
    intr = torch.as_tensor(intr, dtype=torch.float32).to(dev)
    if cfg.propagate:
        params = propagate_moving_points(params, state, targets, intr, cfg.W, cfg.H)
    events = _densify_events(cfg)
    u = densify_uniforms(gen, cfg.max_densify, len(events)).to(dev)
    inputs = dict(params=params, state=state, targets=targets, intr=intr,
                  n_alive=state.n_alive, lrs=lr_schedule(cfg, dyn).to(dev),
                  flow_prior=flow_prior_terms(state, targets, cfg.camera_only, cfg.W, cfg.H))
    if stage_graphs.graphed(dev):
        cache = stage_graphs.DEFAULT_CACHE if graphs is None else graphs
        run = cache.entry(stage_graphs.stage_key(cfg, params.capacity, dev, dyn.weights),
                          lambda: _StageBuffers.of(inputs, cfg), dev, cfg.render.band_devices)
        run.buffers.load(inputs)
        out = torch.clone  # the next stage of this key rewrites buffers and outputs
        checked = stage_graphs.sync_check(dev)
    else:
        run = stage_graphs.Eager(_StageBuffers.of(inputs, cfg))
        out = _same  # fresh buffers, this call's own
        checked = contextlib.nullcontext()
    buf = run.buffers

    def step_fn(b):
        return _iteration(b, cfg, dyn.weights)

    def rebin_fn(b):
        return _rebin(b, cfg)

    at = {e: (kind, k) for k, (kind, e) in enumerate(events)}
    aux = metrics = snaps = None
    with checked:
        if cfg.snapshot_every > 0:
            every = cfg.snapshot_every
            snaps = {k: torch.empty((-(-cfg.iterations // every), cfg.H, cfg.W, 3),
                                    dtype=torch.uint8, device=dev)
                     for k in ("rgb", "depth_map", "center")}
            for i in range(cfg.iterations):
                aux = run("step", step_fn)
                if i in at:  # from this iteration's own error map
                    _densify(buf, cfg, dyn, at[i][0], u[at[i][1]], emap=aux["loss_rgb_pixel"])
                if (i + 1) % every == 0 or i + 1 == cfg.iterations:
                    # aux bound now: a graph reads the step graph's outputs
                    snap = run("snapshot", lambda b, aux=aux: _snapshot(
                        aux, b.params, b.n_alive, b.intr, cfg, dev))
                    for k, stack in snaps.items():
                        stack[i // every].copy_(snap[k])
        else:
            rebin = cfg.rebin_every > 1
            for i in range(cfg.iterations):
                if rebin and i % cfg.rebin_every == 0:
                    run("rebin", rebin_fn)
                metrics = run("step", step_fn)["metrics"]
                if i in at:
                    _densify(buf, cfg, dyn, at[i][0], u[at[i][1]])
                    if rebin:  # new points enter the lists at once
                        run("rebin", rebin_fn)

    if cfg.snapshot_every > 0:
        if aux is None:  # no iteration ran: zero outputs, as the JAX package
            C = params.capacity
            aux = {"uv": torch.zeros((C, 2), device=dev),
                   "depth": torch.zeros((C, 1), device=dev),
                   "rgb": torch.zeros((cfg.H, cfg.W, 3), device=dev),
                   "depth_map": torch.zeros((cfg.H, cfg.W, 1), device=dev),
                   "tile_overflow": torch.zeros((), device=dev),
                   "metrics": {k: torch.zeros((), device=dev) for k in
                               ("rgb", "depth", "var", "scale", "still", "flow", "total")}}
        aux = tree_map(out, aux)
        metrics = aux["metrics"]
    else:
        # one final forward (no grad) for the stage's output render + uv
        with torch.no_grad():
            _, aux = _forward(buf.params, buf.n_alive, buf.state, buf.targets, buf.intr,
                              dyn.weights, cfg, flow_prior=buf.flow_prior,
                              diag_t_final=cfg.telemetry_t_final)
        metrics = tree_map(out, metrics) if metrics is not None else aux["metrics"]
    params, n_alive = tree_map(out, buf.params), out(buf.n_alive)

    if not cfg.camera_only:
        state = finalize_stage(aux["uv"], aux["depth"], params, state,
                               targets.move_mask, n_alive, cfg.W, cfg.H)
    else:
        state = state._replace(n_alive=n_alive)
    # The JAX stage pins its outputs replicated in the tile-sharded mode
    # (gflow_tpu/opt/train.py:621-632). Nothing here needs that: with
    # cfg.render.band_devices only the band composite leaves the stage's
    # device, and its images come back to it, so every output is already
    # on `dev`.
    info = {
        "metrics": metrics,
        "loss_trace": out(buf.losses),
        "n_alive": n_alive,
        **{k: aux[k] for k in ("rgb", "depth_map", "uv", "depth", "tile_overflow")},
    }
    for k in ("t_final_overflow_mean", "t_final_overflow_max"):
        if k in aux:
            info[k] = aux[k]
    if snaps is not None:
        info["snapshots"] = snaps
    if buf.stamps is not None:
        info["stamps"] = out(buf.stamps)
    return params, state, info
