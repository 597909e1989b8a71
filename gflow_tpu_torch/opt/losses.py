"""Loss terms of the fit's hot loop (gflow/trainer.py:452-530).

Counterpart of ``gflow_tpu/opt/losses.py``. All terms work on
fixed-capacity tensors with boolean masks; masked means use
sum(x*m)/max(sum(m), 1), so dead slots contribute nothing. The rgb
term's SSIM is ``ops/ssim.py``'s: its kernels on CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ssim import ssim


class LossWeights(NamedTuple):
    rgb: float = 1.0
    depth: float = 0.0
    var: float = 0.0
    scale: float = 0.0
    still: float = 0.0
    flow: float = 0.0


def masked_mean(x, mask, dim=None):
    mask = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * mask) / torch.sum(mask).clamp_min(1.0)
    return torch.sum(x * mask, dim=dim) / torch.sum(mask, dim=dim).clamp_min(1.0)


def _safe_norm(x, dim, eps=1e-12):
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def _std_unbiased(x, dim):
    """torch.std (correction=1) with a finite gradient at 0."""
    n = x.shape[dim]
    mean = x.mean(dim=dim, keepdim=True)
    return torch.sqrt(torch.sum((x - mean) ** 2, dim=dim) / max(n - 1, 1) + 1e-12)


def _in_bounds(uv, W: int, H: int):
    return (uv[:, 0] > 0) & (uv[:, 0] < W - 1) & (uv[:, 1] > 0) & (uv[:, 1] < H - 1)


def compute_losses(rendered_rgb, rendered_depth_map, uv, point_depth, scale_act,
                   xyz, depth_ab, targets, state, weights: LossWeights,
                   camera_only: bool, W: int, H: int, flow_prior=None):
    """Returns (total_loss, metrics dict, loss_rgb_pixel (H, W)).

    flow_prior: optional precomputed (gt_flow_pts (C, 2), and_mask (C,));
    both depend only on last_uv/targets, so callers hoist them out of the
    iteration loop."""
    C = uv.shape[0]
    slot = torch.arange(C, device=uv.device)
    alive = slot < state.n_alive
    in_prev = slot < state.last_num
    has_last = state.last_num > 0
    metrics = {}

    not_move = ~targets.move_mask
    # rgb: per-pixel MSE + (1 - SSIM)
    if camera_only:
        r = rendered_rgb * not_move[..., None]
        g = targets.image * not_move[..., None]
    else:
        r, g = rendered_rgb, targets.image
    loss_rgb_pixel = torch.mean((r - g) ** 2, dim=-1)
    loss_rgb = loss_rgb_pixel.mean() + (1.0 - ssim(r, g))
    total = weights.rgb * loss_rgb
    metrics["rgb"] = loss_rgb

    # in-bounds mask, filtered by still/move as the reference
    within = _in_bounds(uv, W, H) & alive
    if camera_only:
        part = torch.where(in_prev, state.still_mask, True)
    else:
        part = torch.where(in_prev, ~state.still_mask, True)
    valid = torch.where(has_last, within & part, within)

    # depth: scale/shift-invariant relative L2 on the depth MAP. The
    # denominator has a POSITIVE floor: raw, a learned scale/shift driving
    # it negative turns the loss negative and the fit diverges.
    d_norm = depth_ab[0] * rendered_depth_map + depth_ab[1]
    gt_d = targets.depth
    loss_depth_map = (d_norm - gt_d) ** 2 / (d_norm + gt_d).clamp_min(1e-3)
    if camera_only:
        loss_depth_map = loss_depth_map * not_move[..., None]
    loss_depth = loss_depth_map.mean()
    total = total + weights.depth * loss_depth
    metrics["depth"] = loss_depth

    # var: mean unbiased std of the 3 scale axes
    loss_var = masked_mean(_std_unbiased(scale_act, dim=1), alive)
    total = total + weights.var * loss_var
    metrics["var"] = loss_var

    # scale: ||scale|| / point_depth over in-view points
    safe_d = torch.where(point_depth[:, 0] > 0, point_depth[:, 0], 1.0)
    loss_scale = masked_mean(_safe_norm(scale_act, dim=1) / safe_d, valid)
    total = total + weights.scale * loss_scale
    metrics["scale"] = loss_scale

    # still: anchor still points to the last frame
    still_sel = in_prev & state.still_mask & alive
    loss_still = masked_mean(_safe_norm(xyz - state.last_xyz, dim=1), still_sel)
    loss_still = torch.where(has_last, loss_still, 0.0)
    total = total + weights.still * loss_still
    metrics["still"] = loss_still

    # flow: local flow consistency
    if flow_prior is None:
        flow_prior = flow_prior_terms(state, targets, camera_only, W, H)
    gt_flow_pts, and_mask = flow_prior
    flow_err = torch.mean((uv - state.last_uv - gt_flow_pts) ** 2, dim=1)
    loss_flow = torch.where(has_last, masked_mean(flow_err, and_mask), 0.0)
    total = total + weights.flow * loss_flow
    metrics["flow"] = loss_flow

    metrics["total"] = total
    return total, metrics, loss_rgb_pixel


def flow_prior_terms(state, targets, camera_only: bool, W: int, H: int):
    """The flow loss's per-stage constants: gt flow sampled at last_uv and
    the participation mask."""
    C = state.last_uv.shape[0]
    lu = state.last_uv
    in_prev = torch.arange(C, device=lu.device) < state.last_num
    and_mask = _in_bounds(lu, W, H) & in_prev
    if camera_only:
        and_mask = and_mask & state.still_mask
    else:
        and_mask = and_mask & ~state.still_mask
    xi = lu[:, 0].to(torch.int64).clamp(0, W - 1)
    yi = lu[:, 1].to(torch.int64).clamp(0, H - 1)
    return targets.flow[yi, xi], and_mask
