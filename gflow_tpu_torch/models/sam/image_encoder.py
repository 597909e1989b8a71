"""SAM's image encoder (``segment_anything/modeling/image_encoder.py``): a
plain ViT over 16x16 patches whose blocks attend either within 14x14
windows or, at ``global_attn_indexes``, over the whole token grid, both
with a decomposed relative-position bias, and a convolutional neck to the
prompt width.

Modules are named after the released keys under ``image_encoder.``
(``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, attn.rel_pos_h, attn.rel_pos_w, norm2, mlp.lin1, mlp.lin2}``,
``neck.{0-3}``). Tokens are channels-last (B, h, w, C), as upstream's.

A windowed block zero-pads its normed grid at the bottom and right to a
multiple of the window (64 -> 70 for ViT-H: 25 windows), attends within
each window, merges the windows and crops back. The padded tokens are not
masked: they enter every window's softmax as keys (with value 0 + bias of
``qkv``), as upstream's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import attend


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of a (B, C, H, W) map (eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def rel_index(size: int, device=None) -> torch.Tensor:
    """(size, size) rows of a relative-position table: i - k + size - 1
    for query i and key k."""
    r = torch.arange(size, device=device)
    return r[:, None] - r[None, :] + (size - 1)


def rel_pos_bias(q, rel_pos_h, rel_pos_w, h: int, w: int):
    """The decomposed relative-position bias of queries q (B, h*w, H, D)
    (unscaled) against keys on the same (h, w) grid: (B, H, h*w, h*w),
    rel_h[i, j, k] + rel_w[i, j, l] for query (i, j) and key (k, l), where
    rel_h = q . rel_pos_h[i - k + h - 1] and rel_w = q . rel_pos_w[j - l +
    w - 1]."""
    if rel_pos_h.shape[0] != 2 * h - 1 or rel_pos_w.shape[0] != 2 * w - 1:
        raise ValueError(f"relative-position tables {tuple(rel_pos_h.shape)} / "
                         f"{tuple(rel_pos_w.shape)} do not fit a {h}x{w} grid")
    B, _, Hh, D = q.shape
    r_q = q.permute(0, 2, 1, 3).reshape(B, Hh, h, w, D)
    Rh = rel_pos_h[rel_index(h, q.device)]
    Rw = rel_pos_w[rel_index(w, q.device)]
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, Hh, h * w, h * w)


class Attention(nn.Module):
    """Multi-head self-attention over a (B, h, w, C) grid with the
    decomposed relative-position bias; `size` is the side of the grid it
    attends over (the window, or the whole token grid)."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x):
        B, h, w, C = x.shape
        q, k, v = self.qkv(x).reshape(B, h * w, 3, self.heads, C // self.heads).unbind(2)
        bias = rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, h, w)
        return self.proj(attend(q, k, v, bias).reshape(B, h, w, C))


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * nh * nw, ws, ws, C) windows of the grid
    zero-padded at the bottom and right to multiples of ws, and the
    padded (Hp, Wp)."""
    B, H, W, C = x.shape
    ph, pw = -H % ws, -W % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    """window_partition's inverse: the windows merged and cropped to hw."""
    (Hp, Wp), (H, W) = pad_hw, hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W, :]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm transformer block; `window` 0 attends over the whole grid
    of side `grid`."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, mlp_ratio * dim)

    def forward(self, x):
        y = self.norm1(x)
        if self.window:
            hw = y.shape[1:3]
            y, pad_hw = window_partition(y, self.window)
            y = window_unpartition(self.attn(y), self.window, pad_hw, hw)
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, p: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, p, p)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """(B, 3, S, S) normalized, padded image -> (B, out, S/p, S/p)."""

    def __init__(self, c):
        super().__init__()
        grid = c.image_size // c.patch_size
        dim = c.encoder_embed_dim
        self.patch_embed = PatchEmbed(dim, c.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, c.encoder_num_heads, c.mlp_ratio,
                  0 if i in c.encoder_global_attn_indexes else c.window_size, grid)
            for i in range(c.encoder_depth))
        out = c.prompt_embed_dim
        self.neck = nn.Sequential(nn.Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
                                  nn.Conv2d(out, out, 3, padding=1, bias=False),
                                  LayerNorm2d(out))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))
