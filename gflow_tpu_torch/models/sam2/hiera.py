"""SAM 2's image encoder (``sam2/modeling/backbones/hieradet.py`` and
``image_encoder.py``): the Hiera trunk and the FPN neck.

- ``Hiera``: a 7x7 stride-4 patch embedding, a positional embedding made of
  a background table interpolated bicubically to the token grid plus a
  window table tiled over it, then stages of ``MultiScaleBlock``. A stage's
  first block (but the first stage's) doubles the width and the heads, max
  pools its queries 2x2 (the shortcut is projected from the normed input
  and pooled the same way) and attends within the previous stage's window
  (upstream's ``window_spec`` lags a block); the window is halved by the
  pooling. Blocks in ``global_att_blocks`` attend over the whole grid.
  Each stage's last block is an output, (B, C, H, W).
- ``FpnNeck``: a 1x1 lateral convolution of each output to ``d_model``,
  top-down from the coarsest; the levels in ``fpn_top_down_levels`` add the
  coarser level upsampled 2x by nearest neighbour. ``scalp`` drops the
  coarsest levels after the neck; each kept level has a sine position
  encoding (``sine_pe``), the same for every frame.

Modules are named after the released keys under ``image_encoder.``
(``trunk.patch_embed.proj``, ``trunk.pos_embed``, ``trunk.pos_embed_window``,
``trunk.blocks.{i}.{norm1, attn.qkv, attn.proj, proj, norm2, mlp.layers.0,
mlp.layers.1}``, ``neck.convs.{i}.conv``). Tokens are channels-last (B, H,
W, C), as upstream's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import attend
from ..sam.image_encoder import window_partition, window_unpartition


def sine_pe(channels: int, h: int, w: int, device=None, temperature: float = 10000.0):
    """(1, channels, h, w): upstream's ``PositionEmbeddingSine`` (normalized,
    scale 2 pi) of an h x w grid: the y half then the x half, each
    interleaving sin and cos of the position over temperature ** (2 (i // 2)
    / (channels / 2))."""
    half = channels // 2
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = (y / (y[-1:] + eps) * scale)[:, None].expand(h, w)
    x = (x / (x[-1:] + eps) * scale)[None, :].expand(h, w)
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=3).flatten(2)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=3).flatten(2)
    return torch.cat((py, px), dim=2).permute(2, 0, 1)[None]


class MLP(nn.Module):
    """Linear layers (``layers.{i}``) with `act` between them."""

    def __init__(self, dims, act=F.relu):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = act

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


def pool(x, stride: int):
    """(B, H, W, C) max-pooled stride x stride (floor)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_stride: int):
        super().__init__()
        self.heads, self.q_stride = heads, q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = self.qkv(x).reshape(B, H * W, 3, self.heads, -1).unbind(2)
        if self.q_stride:
            q = pool(q.reshape(B, H, W, -1), self.q_stride)
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.heads, -1)
        return self.proj(attend(q, k, v).reshape(B, H, W, -1))


class MultiScaleBlock(nn.Module):
    """Pre-norm block; `window` 0 attends over the whole grid; `q_stride`
    pools the queries and the shortcut (a stage's first block)."""

    def __init__(self, dim: int, dim_out: int, heads: int, mlp_ratio: float, q_stride: int,
                 window: int):
        super().__init__()
        self.dim, self.dim_out, self.window, self.q_stride = dim, dim_out, window, q_stride
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_stride)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP((dim_out, int(dim_out * mlp_ratio), dim_out), F.gelu)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = pool(shortcut, self.q_stride)
        ws = self.window
        if ws:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws:
            if self.q_stride:
                ws //= self.q_stride
                hw = shortcut.shape[1:3]
                pad_hw = tuple(n + (-n % ws) for n in hw)
            x = window_unpartition(x, ws, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


def block_plan(c):
    """[(dim, dim_out, heads, q_stride, window)] of Hiera's blocks from the
    configuration, as upstream's constructor lays them out: the window of a
    block is that of the stage it starts in, so a stage's first block keeps
    the previous stage's."""
    stage_ends = [sum(c.stages[:i]) - 1 for i in range(1, len(c.stages) + 1)]
    q_pool_blocks = [e + 1 for e in stage_ends[:-1]][:c.q_pool]
    dim, heads, stage, plan = c.embed_dim, c.num_heads, 1, []
    for i in range(sum(c.stages)):
        window = 0 if i in c.global_att_blocks else c.window_spec[stage - 1]
        dim_out = dim
        if i - 1 in stage_ends:
            dim_out, heads = int(dim * c.dim_mul), int(heads * c.head_mul)
            stage += 1
        plan.append((dim, dim_out, heads, c.q_stride if i in q_pool_blocks else 0, window))
        dim = dim_out
    return plan, stage_ends


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, 4, 3)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class Hiera(nn.Module):
    """(B, 3, S, S) normalized image -> the stages' outputs, finest first."""

    def __init__(self, c):
        super().__init__()
        self.patch_embed = PatchEmbed(c.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.embed_dim,
                                                  *c.window_pos_embed_bkg_spatial_size))
        w0 = c.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, c.embed_dim, w0, w0))
        plan, self.stage_ends = block_plan(c)
        self.blocks = nn.ModuleList(MultiScaleBlock(d, do, h, c.mlp_ratio, q, w)
                                    for d, do, h, q, w in plan)

    def pos(self, h: int, w: int):
        """(1, h, w, C): the background table bicubically to (h, w) plus the
        window table tiled over it."""
        pe = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic")
        win = self.pos_embed_window
        pe = pe + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        return pe.permute(0, 2, 3, 1)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos(*x.shape[1:3])
        out = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                out.append(x.permute(0, 3, 1, 2))
        return out


class FpnNeck(nn.Module):
    def __init__(self, d_model: int, channels, top_down_levels):
        super().__init__()
        # convs[0] takes the coarsest level (backbone_channel_list order)
        self.convs = nn.ModuleList(nn.Sequential() for _ in channels)
        for seq, ch in zip(self.convs, channels):
            seq.add_module("conv", nn.Conv2d(ch, d_model, 1))
        self.top_down_levels = tuple(top_down_levels)

    def forward(self, xs):
        n = len(self.convs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i])
            if i in self.top_down_levels and prev is not None:
                prev = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    """Trunk and neck: (B, 3, S, S) -> the kept FPN levels, finest first."""

    def __init__(self, c):
        super().__init__()
        self.trunk = Hiera(c)
        plan, ends = block_plan(c)
        channels = [plan[e][1] for e in ends][::-1]
        self.neck = FpnNeck(c.d_model, channels, c.fpn_top_down_levels)
        self.scalp = c.scalp

    def forward(self, x):
        levels = self.neck(self.trunk(x))
        return levels[:len(levels) - self.scalp]
