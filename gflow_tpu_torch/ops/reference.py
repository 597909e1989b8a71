"""Dense O(N*H*W) reference rasterizer — the correctness oracle.

Counterpart of ``gflow_tpu/ops/reference.py``: composites every Gaussian
against every pixel in global front-to-back depth order, differentiable by
plain autograd. alpha = min(0.99, opa * exp(power)), contributions below
1/255 are skipped, background fills the residual transmittance.
"""
from __future__ import annotations

import torch

from .projection import TILE

ALPHA_CLAMP = 0.99
ALPHA_SKIP = 1.0 / 255.0


def composite_dense(uv, conic, opacity, features, depth, radius, bg, W: int,
                    H: int, tile_consistent: bool = True) -> torch.Tensor:
    """Returns (H, W, F).

    tile_consistent: a Gaussian contributes only to pixels whose 16x16 tile
    intersects its radius-square — the visibility rule of the tiled path."""
    visible = depth[:, 0] > 0
    order = torch.argsort(torch.where(visible, depth[:, 0], torch.inf))
    uv, conic, opacity, features = uv[order], conic[order], opacity[order], features[order]
    visible, radius = visible[order], radius[order]

    dev = uv.device
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    dx = px[None, :] - uv[:, 0:1]  # (N, P)
    dy = py[None, :] - uv[:, 1:2]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacity * torch.exp(power.clamp_max(0.0)), ALPHA_CLAMP)
    alpha = torch.where(power > 0, 0.0, alpha)
    alpha = torch.where(alpha < ALPHA_SKIP, 0.0, alpha)
    alpha = alpha * visible[:, None]

    if tile_consistent:
        n_tx, n_ty = -(-W // TILE), -(-H // TILE)
        tx = torch.div(px, TILE, rounding_mode="floor").to(torch.int32)[None, :]
        ty = torch.div(py, TILE, rounding_mode="floor").to(torch.int32)[None, :]
        rminx, rmaxx, rminy, rmaxy = _tile_rect(uv, radius, n_tx, n_ty)
        in_rect = ((tx >= rminx[:, None]) & (tx < rmaxx[:, None])
                   & (ty >= rminy[:, None]) & (ty < rmaxy[:, None]))
        alpha = torch.where(in_rect, alpha, 0.0)

    trans = torch.cumprod(1.0 - alpha, dim=0)  # inclusive
    trans_excl = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
    out = (alpha * trans_excl).T @ features  # (P, F)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).expand(features.shape[1])
    out = out + trans[-1][:, None] * bg[None, :]
    return out.reshape(H, W, features.shape[1])


def _tile_rect(uv, radius, n_tx: int, n_ty: int):
    """Tile-grid rectangle [min, max) touched by each Gaussian's
    radius-square (the 3DGS tile-binning rule)."""
    def edge(x, n):
        return torch.clamp(torch.floor(x / TILE), 0, n).to(torch.int32)

    return (edge(uv[:, 0] - radius, n_tx),
            edge(uv[:, 0] + radius + TILE - 1, n_tx),
            edge(uv[:, 1] - radius, n_ty),
            edge(uv[:, 1] + radius + TILE - 1, n_ty))
