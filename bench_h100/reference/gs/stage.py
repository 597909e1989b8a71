"""The plain reference of one stage of the per-frame fit, run from the
state the stage starts from to its end: eager float32 PyTorch over the
frozen plain modules of this package, with the arithmetic of the port's
``opt/train.py`` at the commit that defined the benchmark (propagation of
moving points, the static densify schedule, the per-stage learning-rate
rows, the gated Adam step, densify by pixels, the coverage of last frame's
moving points in the camera-only stage).

``mode`` selects the control: "fp32" is the reference; "tf32" runs the
same with TF32 matrix products (the plain compositor blends by a
(P, K) @ (K, F) product). Three more modes plant the faults the check must
catch, in the reference put in the program's place: "unchanged" (a step
returns its state unchanged), "half" (the loss leaves half of the pixels
out) and "altered" (the compositor's output altered where it is
produced)."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .binning import bin_gaussians
from .camera import pix2world, pose_to_extr
from .composite import bg_vector, composite_packed, pack_attrs, untile
from .densify import densify_by_pixels, reset_opt_after_densify
from .losses import LossWeights, compute_losses, flow_prior_terms
from .projection import TILE, project_gaussians, supported_max_radius
from .scene import OPACITY_SENSITIVITY
from .state import FrameState, Params, Targets, adam_update, init_opt_state


@dataclass(frozen=True)
class Binning:
    max_per_tile: int
    max_tiles_per_gaussian: int
    small_tiles_per_gaussian: int = 0
    large_frac: float = 0.125


@dataclass(frozen=True)
class Stage:
    W: int
    H: int
    iterations: int
    camera_only: bool
    propagate: bool
    densify_occ: bool
    densify_interval: int
    densify_times: int
    max_densify: int
    bg: float
    lr: float
    lr_camera: float
    weights: LossWeights
    num_points: float
    densify_occ_percent: float
    densify_err_thre: float
    densify_err_percent: float


@contextlib.contextmanager
def precision(mode: str):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def tile_grid(W: int, H: int):
    return -(-W // TILE), -(-H // TILE)


def activate(params: Params, n_alive):
    alive = (torch.arange(params.capacity, device=params.xyz.device) < n_alive)[:, None]
    scale = torch.abs(params.scale)
    rotate = params.rotate / torch.linalg.norm(params.rotate, dim=-1,
                                               keepdim=True).clamp_min(1e-12)
    opacity = torch.sigmoid(params.opacity * OPACITY_SENSITIVITY) * alive
    return scale, rotate, opacity, torch.sigmoid(params.rgb)


def composite(binning: Binning, bins, uv, conic, opacity, feats, bg, W, H, mode, mov=None):
    n_tx, n_ty = tile_grid(W, H)
    cols = [uv, conic, opacity, feats] + ([mov] if mov is not None else [])
    g_attrs, counts = pack_attrs(bins.tile_lists, bins.tile_counts, torch.cat(cols, dim=1))
    res = composite_packed(g_attrs, counts, bg_vector(bg, feats.shape[1], uv.device), n_tx,
                           with_cov=mov is not None)
    if mode == "altered":
        res = (res[0] + 1e-2, res[1]) if mov is not None else res + 1e-2
    if mov is None:
        return untile(res, n_tx, n_ty, W, H), None
    return untile(res[0], n_tx, n_ty, W, H), untile(res[1], n_tx, n_ty, W, H)


def forward(params: Params, n_alive, state: FrameState, targets: Targets, intr, st: Stage,
            binning: Binning, flow_prior, mode: str):
    extr = pose_to_extr(params.pose)
    scale, rotate, opacity, rgb = activate(params, n_alive)
    if st.camera_only:
        opacity, rgb = opacity.detach(), rgb.detach()
    proj = project_gaussians(params.xyz, scale, rotate, intr, extr, st.W, st.H,
                             max_radius=supported_max_radius(binning.max_tiles_per_gaussian))
    uv, depth = proj["uv"], proj["depth"]
    bins = bin_gaussians(uv, depth, proj["radius"], st.W, st.H,
                         max_per_tile=binning.max_per_tile,
                         max_tiles_per_gaussian=binning.max_tiles_per_gaussian,
                         small_tiles_per_gaussian=binning.small_tiles_per_gaussian,
                         large_frac=binning.large_frac)
    feats = torch.cat([rgb, depth], dim=1)
    move_mask = targets.move_mask
    if st.camera_only:
        slot = torch.arange(params.capacity, device=uv.device)
        mov = ((slot < state.last_num) & ~state.still_mask_tentative)[:, None]
        img, cov = composite(binning, bins, uv, proj["conic"], opacity, feats, st.bg, st.W,
                             st.H, mode, mov=mov.to(torch.float32))
        move_mask = move_mask | (cov[..., 0] > 0)
    else:
        img, _ = composite(binning, bins, uv, proj["conic"], opacity, feats, st.bg, st.W,
                           st.H, mode)
    rgb_map, depth_map = img[..., :3], img[..., 3:4]
    if mode == "half":
        keep = (torch.arange(st.H, device=uv.device) < st.H // 2)[:, None, None]
        rgb_map = torch.where(keep, rgb_map, targets.image)
        depth_map = torch.where(keep, depth_map, targets.depth)
    total, metrics, emap = compute_losses(
        rgb_map, depth_map, uv, depth, scale, params.xyz, params.depth_ab,
        targets._replace(move_mask=move_mask), state._replace(n_alive=n_alive), st.weights,
        st.camera_only, st.W, st.H, flow_prior=flow_prior)
    return total, emap


def gate(grads: Params, state: FrameState, camera_only: bool) -> Params:
    grads = Params(*(torch.where(torch.isfinite(g), g, 0.0) for g in grads))
    in_prev = torch.arange(grads.capacity, device=grads.xyz.device) < state.last_num
    rgb = torch.where(state.last_num > 0, 0.0, grads.rgb)
    xyz = torch.where((in_prev & state.still_mask)[:, None], 0.0, grads.xyz)
    grads = grads._replace(rgb=rgb, xyz=xyz)
    if camera_only:
        grads = grads._replace(**{k: torch.zeros_like(getattr(grads, k))
                                  for k in ("xyz", "scale", "rotate", "opacity", "rgb")})
    return grads


def propagate(params: Params, state: FrameState, targets: Targets, intr, W: int, H: int):
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
    return params._replace(xyz=torch.where((moving & within)[:, None], xyz_new, params.xyz))


def densify_events(st: Stage):
    events = []
    if not st.camera_only:
        if st.densify_occ:
            events.append(("occ", 0))
        if st.densify_interval > 0:
            for t in range(1, st.densify_times + 1):
                e = st.densify_interval * t - 1
                if e < st.iterations and ("occ", e) not in events:
                    events.append(("err", e))
    return sorted(events, key=lambda kv: kv[1])


def lr_rows(st: Stage) -> np.ndarray:
    """Row i: iteration i's learning rates (attributes, pose, depth_ab):
    LinearLR 1.0 -> 0.1 over the stage up to the first densify, then the
    constant attribute lr with pose and depth frozen."""
    events = densify_events(st)
    post = events[0][1] + 1 if events else st.iterations
    i = np.arange(st.iterations, dtype=np.float32)
    factor = (np.float32(1.0) - np.float32(0.9) * i / np.float32(st.iterations)).astype(
        np.float64)
    lr, lr_cam = float(np.float32(st.lr)), float(np.float32(st.lr_camera))
    rows = np.stack([lr * factor, lr_cam * factor, lr * factor], axis=1).astype(np.float32)
    rows[post:] = (lr, 0.0, 0.0)
    return rows


def run_stage(params: Params, state: FrameState, targets: Targets, intr, st: Stage,
              binning: Binning, generator: torch.Generator, keep_at: int,
              mode: str = "fp32") -> dict:
    """The stage from the state it starts from to its end. `generator` is
    in the state the stage's densify draws start from (one row of
    max_densify uniforms per event). Returns every iteration's loss
    ("losses"), the gated gradient of the first iteration ("grad0"), the
    parameters as the first iteration starts from them ("start", after the
    propagation), after `keep_at` iterations ("at") and at the end ("end"),
    n_alive at the start and at the end."""
    dev = params.xyz.device
    with precision(mode):
        if st.propagate:
            params = propagate(params, state, targets, intr, st.W, st.H)
        events = densify_events(st)
        u = [torch.rand(st.max_densify, generator=generator, device=dev) for _ in events]
        at = {e: (kind, k) for k, (kind, e) in enumerate(events)}
        rows = torch.from_numpy(lr_rows(st)).to(dev)
        flow_prior = flow_prior_terms(state, targets, st.camera_only, st.W, st.H)
        opt = init_opt_state(params)
        n_alive = state.n_alive
        rec = {"start": list(params), "n_alive_start": int(n_alive)}
        losses = []
        for i in range(st.iterations):
            leaves = [p.detach().requires_grad_() for p in params]
            total, _ = forward(Params(*leaves), n_alive, state, targets, intr, st, binning,
                               flow_prior, mode)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = Params(*(torch.zeros_like(x) if g is None else g
                             for g, x in zip(grads, leaves)))
            grads = gate(grads, state, st.camera_only)
            if i == 0:
                rec["grad0"] = list(grads)
            if mode == "unchanged":
                params = Params(*(x.detach() for x in leaves))
            else:
                params, opt = adam_update(Params(*(x.detach() for x in leaves)), grads, opt,
                                          rows[i, 0], rows[i, 1], rows[i, 2])
            losses.append(total.detach())
            if i in at:
                kind, k = at[i]
                with torch.no_grad():
                    if kind == "err":
                        emap = forward(params, n_alive, state, targets, intr, st, binning,
                                       flow_prior, mode)[1]
                        mask, percent = emap > st.densify_err_thre, st.densify_err_percent
                    else:
                        emap = torch.ones((st.H, st.W), dtype=torch.float32, device=dev)
                        mask, percent = targets.occ_mask, st.densify_occ_percent
                    params, n_alive, _ = densify_by_pixels(
                        params, n_alive, emap, mask, targets.image, targets.depth, intr,
                        pose_to_extr(params.pose), st.num_points, percent, u[k])
                    opt = reset_opt_after_densify(opt, params)
            if i + 1 == keep_at:
                rec["at"] = list(params)
    rec.update(losses=torch.stack(losses).cpu().tolist(), end=list(params),
               n_alive_end=int(n_alive))
    return rec
