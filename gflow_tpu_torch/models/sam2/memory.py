"""SAM 2's memory: the memory attention that conditions a frame's features
on the memory bank, and the memory encoder that turns a frame's mask into
a memory (``sam2/modeling/memory_attention.py``, ``memory_encoder.py``,
``sam/transformer.py`` ``RoPEAttention``, ``position_encoding.py``).

- ``rope_tables``: 2-D axial rotary encoding of a w x h grid (upstream's
  ``compute_axial_cis``): channel pair j < D/4 turns by x * theta^(-4j/D),
  pair D/4 + j by y * theta^(-4j/D), x fastest over the tokens. Kept as
  (cos, sin) tables, (N, D/2); ``rope`` applies them to pairs of channels
  as upstream's complex product does, (a + ib)(cos + i sin).
- ``RoPEAttention``: attention whose queries, and keys but the last
  ``num_k_exclude_rope`` (the object pointers), are rotated; keys longer
  than the queries take the table once per memory frame
  (``rope_k_repeat``). Keys and values come in at ``kv_in_dim``.
- ``MemoryAttention``: ``+ 0.1 * pos`` at the input, then layers of pre-norm
  self-attention (RoPE), cross-attention to the memory (keys = memory +
  memory PE; RoPE) and a ReLU MLP, a final LayerNorm.
- ``MemoryEncoder``: the mask downsampled by stride-2 3x3 convolutions
  (LayerNorm2d, GELU) and a 1x1 one, added to the frame's features through a
  1x1 projection, two ConvNeXt blocks, out-projected to the memory width.

Modules are named after the released keys under ``memory_attention.`` and
``memory_encoder.``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import attend
from ..sam.image_encoder import LayerNorm2d


# the bytes of one block of attention scores: the queries are taken in
# blocks so that a block's scores (batch x queries x keys, float32) stay
# under this. The pipeline records one CUDA graph per fill of the memory
# bank, and each capture keeps the memory of its own peak (its warm-up's
# and its private pool's, on streams of its own), so the scores over
# 28,736 keys (1.41 GB a layer at 3 objects) would cost ~3 GB a graph.
SCORE_BLOCK_BYTES = 1 << 28


def rope_tables(dim: int, end_x: int, end_y: int, theta: float = 10000.0, device=None):
    """(cos, sin), each (end_x * end_y, dim // 2): the x channel pairs' then
    the y pairs' angles of every token (x fastest)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4, device=device)[:dim // 4].float() / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    t_x = t % end_x
    t_y = torch.div(t, end_x, rounding_mode="floor")
    ang = torch.cat([torch.outer(t_x, freqs), torch.outer(t_y, freqs)], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    """x (B, N, H, D) with channels (2j, 2j + 1) turned by the table's row n,
    pair j; the table (N', D/2) repeats over N = r N' (memory frames)."""
    B, N, H, D = x.shape
    r = N // cos.shape[0]
    if r > 1:
        cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
    p = x.reshape(B, N, H, D // 2, 2)
    a, b = p[..., 0], p[..., 1]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(B, N, H, D)


class RoPEAttention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_in_dim: int | None = None):
        super().__init__()
        kv = kv_in_dim or dim
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(kv, dim)
        self.v_proj = nn.Linear(kv, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, cos, sin, num_k_exclude_rope: int = 0):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, -1)
        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        q = rope(q, cos, sin)
        n = k.shape[1] - num_k_exclude_rope
        if num_k_exclude_rope:
            k = torch.cat([rope(k[:, :n], cos, sin), k[:, n:]], dim=1)
        else:
            k = rope(k, cos, sin)
        B, Nq, H, _ = q.shape
        block = max(1, SCORE_BLOCK_BYTES // (4 * B * H * k.shape[1]))
        if block >= Nq:
            return self.out_proj(attend(q, k, v))
        return self.out_proj(torch.cat([attend(q[:, i:i + block], k, v)
                                        for i in range(0, Nq, block)], dim=1))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int, kv_in_dim: int):
        super().__init__()
        self.self_attn = RoPEAttention(dim, heads)
        self.cross_attn_image = RoPEAttention(dim, heads, kv_in_dim)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, memory_k, memory, cos, sin, num_ptr_tokens: int):
        """x (B, N, C) the frame's tokens; memory_k = memory + its PE and
        memory (B, M, kv_in_dim)."""
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y, cos, sin)
        x = x + self.cross_attn_image(self.norm2(x), memory_k, memory, cos, sin, num_ptr_tokens)
        return x + self.linear2(F.relu(self.linear1(self.norm3(x))))


class MemoryAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(c.d_model, c.memattn_heads, c.memattn_ffn, c.mem_dim)
            for _ in range(c.memattn_layers))
        self.norm = nn.LayerNorm(c.d_model)
        self.rope_theta = c.rope_theta

    def forward(self, curr, curr_pos, memory, memory_pos, num_ptr_tokens: int, hw):
        """curr, curr_pos (B, N, C) on an h x w grid; memory, memory_pos (B,
        M, kv_in_dim), its last num_ptr_tokens the object pointers ->
        (B, N, C)."""
        heads = self.layers[0].self_attn.heads
        cos, sin = rope_tables(curr.shape[-1] // heads, hw[1], hw[0], self.rope_theta,
                               curr.device)
        x = curr + 0.1 * curr_pos
        memory_k = memory + memory_pos
        for layer in self.layers:
            x = layer(x, memory_k, memory, cos, sin, num_ptr_tokens)
        return self.norm(x)


class MaskDownSampler(nn.Module):
    """(B, 1, S, S) -> (B, C, S / total_stride, ...): convolutions of
    `kernel` / `stride` / `padding`, each times stride^2 the channels, with
    LayerNorm2d and GELU, and a 1x1 one to `dim` (``encoder.{i}``)."""

    def __init__(self, dim: int, kernel: int, stride: int, padding: int, total_stride: int):
        super().__init__()
        layers = int(math.log2(total_stride) // math.log2(stride))
        mods, cin = [], 1
        for _ in range(layers):
            cout = cin * stride ** 2
            mods += [nn.Conv2d(cin, cout, kernel, stride, padding), LayerNorm2d(cout), nn.GELU()]
            cin = cout
        mods.append(nn.Conv2d(cin, dim, 1))
        self.encoder = nn.Sequential(*mods)

    def forward(self, x):
        return self.encoder(x)


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, LayerNorm2d, 4x MLP with GELU, layer
    scale ``gamma``, residual."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        y = self.gamma * self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + y.permute(0, 3, 1, 2)


class Fuser(nn.Module):
    def __init__(self, dim: int, kernel: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim, kernel) for _ in range(layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c.d_model
        self.mask_downsampler = MaskDownSampler(d, c.mask_ds_kernel, c.mask_ds_stride,
                                                c.mask_ds_padding, c.mask_ds_total_stride)
        self.pix_feat_proj = nn.Conv2d(d, d, 1)
        self.fuser = Fuser(d, c.fuser_kernel, c.fuser_layers)
        self.out_proj = nn.Conv2d(d, c.mem_dim, 1)

    def forward(self, pix_feat, masks):
        """pix_feat (1 or B, C, h, w), masks (B, 1, S, S) already through the
        sigmoid, scale and bias -> (B, mem_dim, h, w)."""
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        return self.out_proj(self.fuser(x))
