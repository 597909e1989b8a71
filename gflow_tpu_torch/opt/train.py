"""One optimization stage of the per-frame fit (SimpleGaussian.train(),
gflow/trainer.py:332-711).

Counterpart of ``gflow_tpu/opt/train.py``: a Python loop of render ->
loss -> backward -> gated Adam. Each iteration composites one fused
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
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import pix2world, pose_to_extr
from ..core.scene import OPACITY_SENSITIVITY
from ..ops.binning import tile_grid
from ..ops.projection import TILE, project_gaussians, supported_max_radius
from ..ops.render import (DEFAULT_CONFIG, RenderConfig, bin_with, composite,
                          composite_with_coverage, render)
from ..viz.colormap import apply_float_colormap
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
             diag_t_final: bool = False, bins=None):
    """Render + losses. Returns (total, aux). bins: tile lists carried by
    the rebinning loop; None bins this forward's own projection.

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


def _to(tup, dev):
    return type(tup)(*(x.to(dev) for x in tup))


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
                device=None):
    """Run one optimization stage on `device` (``cuda`` unless the caller
    passes another). `gen` draws the densify uniforms. Returns (params,
    state, info); info["loss_trace"] holds every iteration's total loss and,
    on the snapshot path, info["snapshots"] the uint8 stacks (n_chunks, H,
    W, 3) under "rgb", "depth_map" and "center"."""
    dev = resolve_device(device)
    params, state, targets = _to(params, dev), _to(state, dev), _to(targets, dev)
    intr = torch.as_tensor(intr, dtype=torch.float32).to(dev)
    if cfg.propagate:
        params = propagate_moving_points(params, state, targets, intr, cfg.W, cfg.H)
    opt_state = init_opt_state(params)
    n_alive = state.n_alive
    flow_prior = flow_prior_terms(state, targets, cfg.camera_only, cfg.W, cfg.H)

    def forward(p, n, diag_t_final=False, bins=None):
        return _forward(p, n, state, targets, intr, dyn.weights, cfg,
                        flow_prior=flow_prior, diag_t_final=diag_t_final, bins=bins)

    def step(i, params, opt_state, n_alive, bins=None):
        """Forward + gated grads + Adam. LinearLR 1.0 -> 0.1 over the stage
        (trainer.py:384), frozen at constant attribute lr after densify."""
        leaves = [p.detach().requires_grad_() for p in params]
        total, aux = forward(Params(*leaves), n_alive, bins=bins)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = Params(*(torch.zeros_like(x) if g is None else g
                         for g, x in zip(grads, leaves)))
        grads = _gate_grads(grads, state, n_alive, cfg.camera_only)
        # float32 schedule arithmetic, as the reference computes it
        factor = float(np.float32(1.0) - np.float32(0.9) * np.float32(i)
                       / np.float32(cfg.iterations))
        lr, lr_cam = float(np.float32(dyn.lr)), float(np.float32(dyn.lr_camera))
        if opt_state.post_densify:
            lrs = (lr, 0.0, 0.0)
        else:
            lrs = (float(np.float32(lr * factor)), float(np.float32(lr_cam * factor)),
                   float(np.float32(lr * factor)))
        params, opt_state = adam_update(Params(*(x.detach() for x in leaves)), grads,
                                        opt_state, *lrs)
        aux = {k: ({m: x.detach() for m, x in v.items()} if k == "metrics" else v.detach())
               for k, v in aux.items()}
        return params, opt_state, total.detach(), aux

    def apply_densify(params, opt_state, n_alive, kind, emap=None):
        """kind "occ": uniform map over the occ mask; "err": the rgb error
        above threshold, from `emap` or, without one, from one extra forward
        at the current parameters."""
        u = torch.rand(cfg.max_densify, generator=gen, device=gen.device).to(dev)
        if kind == "err":
            if emap is None:
                with torch.no_grad():
                    emap = forward(params, n_alive)[1]["loss_rgb_pixel"]
            mask = emap > dyn.densify_err_thre
            percent = dyn.densify_err_percent
        else:
            emap = torch.ones((cfg.H, cfg.W), dtype=torch.float32, device=dev)
            mask = targets.occ_mask
            percent = dyn.densify_occ_percent
        params, n_alive, _ = densify_by_pixels(
            params, n_alive, emap, mask, targets.image, targets.depth, intr,
            pose_to_extr(params.pose), dyn.num_points, percent, u)
        return params, reset_opt_after_densify(opt_state, params), n_alive

    losses, aux, snaps = [], None, []
    events = {e: kind for kind, e in _densify_events(cfg)}
    if cfg.snapshot_every > 0:
        for i in range(cfg.iterations):
            params, opt_state, loss, aux = step(i, params, opt_state, n_alive)
            losses.append(loss)
            if i in events:  # from this iteration's own error map
                params, opt_state, n_alive = apply_densify(
                    params, opt_state, n_alive, events[i], emap=aux["loss_rgb_pixel"])
            if (i + 1) % cfg.snapshot_every == 0 or i + 1 == cfg.iterations:
                with torch.no_grad():
                    snaps.append(_snapshot(aux, params, n_alive, intr, cfg, dev))
        if aux is None:  # no iteration ran: zero outputs, as the JAX package
            C = params.capacity
            aux = {"uv": torch.zeros((C, 2), device=dev),
                   "depth": torch.zeros((C, 1), device=dev),
                   "rgb": torch.zeros((cfg.H, cfg.W, 3), device=dev),
                   "depth_map": torch.zeros((cfg.H, cfg.W, 1), device=dev),
                   "tile_overflow": torch.zeros((), device=dev),
                   "metrics": {k: torch.zeros((), device=dev) for k in
                               ("rgb", "depth", "var", "scale", "still", "flow", "total")}}
        metrics = aux["metrics"]
    else:
        rebin = cfg.rebin_every > 1
        bins, metrics = None, None
        for i in range(cfg.iterations):
            if rebin and i % cfg.rebin_every == 0:
                bins = _compute_bins(params, n_alive, intr, cfg)
            params, opt_state, loss, step_aux = step(i, params, opt_state, n_alive, bins)
            losses.append(loss)
            metrics = step_aux["metrics"]
            if i in events:
                params, opt_state, n_alive = apply_densify(params, opt_state, n_alive,
                                                           events[i])
                if rebin:  # new points enter the lists at once
                    bins = _compute_bins(params, n_alive, intr, cfg)
        # one final forward (no grad) for the stage's output render + uv
        with torch.no_grad():
            _, aux = forward(params, n_alive, diag_t_final=cfg.telemetry_t_final)
        metrics = metrics if metrics is not None else aux["metrics"]

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
        "loss_trace": torch.stack(losses) if losses else torch.zeros(0, device=dev),
        "n_alive": n_alive,
        **{k: aux[k] for k in ("rgb", "depth_map", "uv", "depth", "tile_overflow")},
    }
    for k in ("t_final_overflow_mean", "t_final_overflow_max"):
        if k in aux:
            info[k] = aux[k]
    if cfg.snapshot_every > 0:
        info["snapshots"] = {k: torch.stack([sn[k] for sn in snaps]) if snaps else
                             torch.zeros((0, cfg.H, cfg.W, 3), dtype=torch.uint8, device=dev)
                             for k in ("rgb", "depth_map", "center")}
    return params, state, info
