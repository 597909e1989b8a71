"""Per-tile front-to-back alpha compositing in plain PyTorch.

Counterpart of ``gflow_tpu/ops/composite.py``, and the plain version of the
CUDA kernels in ``ops/cuda_raster.py``: the wrappers there composite CPU
tensors through ``composite_packed`` here, and autograd through it is the
plain version of the backward kernel K3. With fixed per-tile capacity K and
depth-sorted lists,

    out[p] = sum_k f_k * alpha_k[p] * prod_{j<k} (1 - alpha_j[p]) + T_final * bg

is an exclusive cumulative product over K followed by a (P, K) @ (K, F)
product. It materializes (T, K, 256) tensors: fine for the tests' sizes and
for a comparison run on the card, not meant to be fast.
"""
from __future__ import annotations

import torch

from .projection import TILE
from .tiles import ALPHA_CLAMP, ALPHA_SKIP

P_PIX = TILE * TILE


def tile_alpha(c_uv, c_conic, c_op, c_px, c_py):
    """(C, K, ·) per-tile attributes at (C, P) pixels -> alpha (C, K, P)."""
    dx = c_px[:, None, :] - c_uv[:, :, 0:1]
    dy = c_py[:, None, :] - c_uv[:, :, 1:2]
    a, b, c = c_conic[:, :, 0:1], c_conic[:, :, 1:2], c_conic[:, :, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    # clamp before exp: a PSD conic keeps power <= 0, but garbage rows could
    # overflow exp and poison gradients with inf*0
    alpha = torch.clamp_max(c_op * torch.exp(power.clamp_max(0.0)), ALPHA_CLAMP)
    alpha = torch.where(power > 0, 0.0, alpha)
    return torch.where(alpha < ALPHA_SKIP, 0.0, alpha)


def blend_tile_block(c_uv, c_conic, c_op, c_feat, c_px, c_py, bg):
    """Front-to-back alpha blend of a (C, K, ·) block of per-tile gathered
    attributes onto (C, P) pixel coordinates -> (C, P, F)."""
    alpha = tile_alpha(c_uv, c_conic, c_op, c_px, c_py)
    trans = _Cumprod.apply(1.0 - alpha, 1)  # inclusive, (C, K, P)
    trans_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    out = torch.einsum("ckp,ckf->cpf", alpha * trans_excl, c_feat)
    return out + trans[:, -1][:, :, None] * bg[None, None, :]


class _Cumprod(torch.autograd.Function):
    """torch.cumprod(x, dim) of an x without zeros (1 - alpha, alpha at most
    ALPHA_CLAMP < 1). The backward is torch's own for that case, the
    reversed cumulative sum of out * grad over x, without the test for
    zeros that torch's runs first: it reads a flag back to the host, which
    a CUDA graph cannot record."""

    @staticmethod
    def forward(ctx, x, dim: int):
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[ctx.dim] == 1:
            return grad, None
        d = ctx.dim
        return (out * grad).flip(d).cumsum(d).flip(d).div(x), None


def tile_pixels(T: int, n_tx: int, device, row0: int = 0):
    """(T, P) float pixel x / y of every tile's 16x16 block; pixel i of tile
    t sits at (tx0 + i % 16, ty0 + i // 16), integer coordinates, tile t in
    tile row t // n_tx + row0 (row0: a band's first tile row)."""
    t = torch.arange(T, device=device)
    i = torch.arange(P_PIX, device=device)
    px = (t % n_tx)[:, None] * TILE + (i % TILE)[None, :]
    py = (torch.div(t, n_tx, rounding_mode="floor")[:, None] + row0) * TILE + torch.div(
        i, TILE, rounding_mode="floor")[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def composite_packed(g_attrs, counts, bg, n_tx: int, with_cov: bool = False, row0: int = 0):
    """Plain version of kernels K1 (with_cov False) and K2 (True).

    g_attrs (T, K, CA) rows [uv 2, conic 3, opacity 1, feat F (, mov 1)],
    counts (T,) live rows per tile (<= K), bg (F,); the tiles start at tile
    row row0. Returns out (T, P, F) and, with_cov, the coverage
    max_k(alpha_k * mov_k) (T, P, 1), which carries no gradient."""
    T, K, CA = g_attrs.shape
    F = CA - 6 - int(with_cov)
    alive = torch.arange(K, device=g_attrs.device)[None, :] < counts[:, None]
    op = torch.where(alive[..., None], g_attrs[..., 5:6], 0.0)
    px, py = tile_pixels(T, n_tx, g_attrs.device, row0)
    out = blend_tile_block(g_attrs[..., 0:2], g_attrs[..., 2:5], op,
                           g_attrs[..., 6:6 + F], px, py, bg)
    if not with_cov:
        return out
    with torch.no_grad():
        alpha = tile_alpha(g_attrs[..., 0:2], g_attrs[..., 2:5], op, px, py)
        cov = torch.amax(alpha * g_attrs[..., 6 + F:7 + F], dim=1)[..., None]
    return out, cov


def pack_attrs(tile_lists, tile_counts, attrs):
    """ONE wide row gather attrs[safe] -> (T, K, CA) plus the live-row counts
    min(tile_counts, K). Slots past a tile's count gather row 0 harmlessly:
    the compositor ignores them. Autograd's transpose of the gather
    scatter-adds the per-slot gradients back to the Gaussians."""
    T, K = tile_lists.shape
    if tile_counts is None:
        counts = (tile_lists >= 0).sum(dim=1)
    else:
        counts = tile_counts.clamp_max(K)
    safe = tile_lists.clamp_min(0).reshape(-1).long()
    g_attrs = attrs.index_select(0, safe).reshape(T, K, attrs.shape[1])
    return g_attrs, counts.to(torch.int32).contiguous()


def untile(out, n_tx: int, n_ty: int, W: int, H: int):
    """(T, P, C) per-tile pixels -> (H, W, C) image."""
    C = out.shape[-1]
    img = (out.reshape(n_ty, n_tx, TILE, TILE, C).permute(0, 2, 1, 3, 4)
           .reshape(n_ty * TILE, n_tx * TILE, C))
    return img[:H, :W]


def bg_vector(bg, F: int, device):
    """The (F,) float32 background. A Python number is filled in on the
    device: no host copy, so that a CUDA graph can record it."""
    if isinstance(bg, (int, float)):
        return torch.full((F,), float(bg), dtype=torch.float32, device=device)
    return torch.as_tensor(bg, dtype=torch.float32, device=device).expand(F).contiguous()
