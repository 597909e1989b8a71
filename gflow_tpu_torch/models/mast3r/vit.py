"""MASt3R/DUSt3R two-view network, in PyTorch: the depth and camera prior
model the reference runs offline (CroCo-v2: ViT-Large encoder with 2D
RoPE, twin cross-attending decoders, pointmap + confidence (+ descriptor)
heads).

Counterpart of ``gflow_tpu/models/mast3r/vit.py``. Modules are named after
the released CroCo/DUSt3R keys (``patch_embed.proj``, ``enc_blocks.{i}``,
``enc_norm``, ``decoder_embed``, ``dec_blocks.{i}`` / ``dec_blocks2.{i}``,
``dec_norm``, ``downstream_head{1,2}``), so a released state dict loads
with ``load_state_dict(strict=True)`` once ``convert._IGNORED_PREFIXES``
are dropped (``convert.load_weights``). Attention is plain matrix
products (``models/attention.py``, shared with SAM); GELU is exact erf
and LayerNorm eps 1e-6, as CroCo's. Inputs and outputs are
channels-last, as the JAX model's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import attend
from ..precision import fp32_math
from .dpt_head import CatMlpDptHead, pixel_shuffle_tokens, reg_dense_pts3d


@dataclass(frozen=True)
class Mast3rConfig:
    patch_size: int = 16
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    rope_base: float = 100.0
    desc_dim: int = 24
    with_desc: bool = True
    # 'linear' (DUSt3R *_linear) or 'catmlp+dpt' (the MASt3R checkpoint the
    # reference loads)
    head: str = "linear"


def rope_2d(q: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """2D rotary position embedding (CroCo RoPE2D). q: (B, N, H, D), D
    divisible by 4; positions: (N, 2) (y, x) patch coordinates. The first
    half of the head dim rotates with y, the second with x; within each
    half the rotation pairs are the chunked halves (rotate_half)."""
    half = q.shape[-1] // 2
    d4 = half // 2
    freq = 1.0 / (base ** (torch.arange(d4, dtype=torch.float32, device=q.device) / d4))

    def rot(v, pos):
        ang = pos.to(torch.float32)[:, None] * freq[None, :]
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
        v1, v2 = v[..., :d4], v[..., d4:]
        return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], -1)

    return torch.cat([rot(q[..., :half], positions[:, 0]),
                      rot(q[..., half:], positions[:, 1])], -1)


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, rope_base):
        super().__init__()
        self.heads, self.rope_base = heads, rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.unbind(2)
        q, k = rope_2d(q, pos, self.rope_base), rope_2d(k, pos, self.rope_base)
        return self.proj(attend(q, k, v))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, rope_base):
        super().__init__()
        self.heads, self.rope_base = heads, rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, kv, pos_q, pos_kv):
        B, Nq, C = x.shape
        split = lambda t: t.reshape(B, t.shape[1], self.heads, C // self.heads)
        q = rope_2d(split(self.projq(x)), pos_q, self.rope_base)
        k = rope_2d(split(self.projk(kv)), pos_kv, self.rope_base)
        return self.proj(attend(q, k, split(self.projv(kv))))


class Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-6)


class EncoderBlock(nn.Module):
    def __init__(self, dim, heads, rope_base):
        super().__init__()
        self.norm1, self.norm2 = _ln(dim), _ln(dim)
        self.attn = SelfAttention(dim, heads, rope_base)
        self.mlp = Mlp(dim)

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """CroCo decoder block: self-attention, cross-attention to the
    (norm_y'd) other view, MLP, with pre-norms norm1/norm2/norm3."""

    def __init__(self, dim, heads, rope_base):
        super().__init__()
        self.norm1, self.norm2, self.norm3, self.norm_y = _ln(dim), _ln(dim), _ln(dim), _ln(dim)
        self.attn = SelfAttention(dim, heads, rope_base)
        self.cross_attn = CrossAttention(dim, heads, rope_base)
        self.mlp = Mlp(dim)

    def forward(self, x, y, pos, pos_y):
        x = x + self.attn(self.norm1(x), pos)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), pos, pos_y)
        return x + self.mlp(self.norm3(x))


class LinearHead(nn.Module):
    """DUSt3R linear head (``proj``): tokens -> per-pixel pts3d(3) + conf(1)
    through the pixel shuffle, 'exp' regression; optional descriptor
    extension (``desc_proj``). Outputs are channels-last."""

    def __init__(self, cfg: Mast3rConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Linear(cfg.dec_dim, 4 * p * p)
        if cfg.with_desc:
            self.desc_proj = nn.Linear(cfg.dec_dim, (cfg.desc_dim + 1) * p * p)

    def forward(self, x, hw, img_hw):
        c, (h, w), (H, W) = self.cfg, hw, img_hw
        p = c.patch_size
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        y = pixel_shuffle_tokens(self.proj(x), h, w, 4, p)[:, :, :H, :W]
        out = {"pts3d": nhwc(reg_dense_pts3d(y[:, :3])),
               "conf": nhwc(1.0 + torch.exp(y[:, 3:4].clamp(-20.0, 20.0)))}
        if c.with_desc:
            d = pixel_shuffle_tokens(self.desc_proj(x), h, w, c.desc_dim + 1, p)[:, :, :H, :W]
            desc = d[:, :c.desc_dim]
            out["desc"] = nhwc(desc / torch.linalg.vector_norm(
                desc, dim=1, keepdim=True).clamp_min(1e-8))
            out["desc_conf"] = nhwc(1.0 + torch.exp(d[:, -1:].clamp(-20.0, 20.0)))
        return out


class PatchEmbed(nn.Module):
    """p x p patches at stride p. A side that is no multiple of p is
    zero-padded as the JAX model's 'SAME' convolution pads it (half the
    shortfall before, the rest after), so its last patch covers it."""

    def __init__(self, dim, p):
        super().__init__()
        self.p = p
        self.proj = nn.Conv2d(3, dim, p, p)

    def forward(self, x):
        H, W = x.shape[2:]
        ph, pw = -H % self.p, -W % self.p
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.proj(x)


class Mast3rModel(nn.Module):
    """Two-view model: (img1, img2) (B, H, W, 3) in [0, 1] -> per-view dicts
    of channels-last maps; view 2's points live in view 1's camera frame
    (the DUSt3R convention the alignment relies on)."""

    def __init__(self, config: Mast3rConfig = Mast3rConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = PatchEmbed(c.enc_dim, c.patch_size)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(c.enc_dim, c.enc_heads, c.rope_base) for _ in range(c.enc_depth))
        self.enc_norm = _ln(c.enc_dim)
        self.decoder_embed = nn.Linear(c.enc_dim, c.dec_dim)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(c.dec_dim, c.dec_heads, c.rope_base) for _ in range(c.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(c.dec_dim, c.dec_heads, c.rope_base) for _ in range(c.dec_depth))
        self.dec_norm = _ln(c.dec_dim)
        if c.head == "catmlp+dpt":
            ld = c.dec_depth
            self.hooks = (0, ld * 2 // 4, ld * 3 // 4, ld)
            dims = tuple(c.enc_dim if h == 0 else c.dec_dim for h in self.hooks)
            make = lambda: CatMlpDptHead(dims, c.enc_dim, c.dec_dim, c.patch_size, c.desc_dim)
        elif c.head == "linear":
            make = lambda: LinearHead(c)
        else:
            raise ValueError(f"unknown head {c.head!r} (linear | catmlp+dpt)")
        self.downstream_head1, self.downstream_head2 = make(), make()

    def encode(self, img):
        """Both views' images (2B, H, W, 3) -> tokens (2B, N, E), (N, 2)
        (y, x) positions and the token grid (h, w)."""
        x = self.patch_embed(img.permute(0, 3, 1, 2) * 2 - 1)
        B, E, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        ys = torch.arange(h, device=x.device).repeat_interleave(w)
        xs = torch.arange(w, device=x.device).repeat(h)
        pos = torch.stack([ys, xs], dim=1)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos, (h, w)

    def forward(self, img1, img2):
        with fp32_math():
            return self._forward(img1, img2)

    def _forward(self, img1, img2):
        c = self.config
        B, H, W, _ = img1.shape
        t, pos, hw = self.encode(torch.cat([img1, img2]))
        t1, t2 = t[:B], t[B:]
        x1, x2 = self.decoder_embed(t1), self.decoder_embed(t2)
        # decoder outputs, dust3r convention: [encoder tokens, block 1, ...,
        # block N (dec_norm'd)]; both sides read the other's previous tokens
        outs1, outs2 = [t1], [t2]
        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = b1(x1, x2, pos, pos), b2(x2, x1, pos, pos)
            outs1.append(x1)
            outs2.append(x2)
        d1, d2 = self.dec_norm(x1), self.dec_norm(x2)
        outs1[-1], outs2[-1] = d1, d2
        if c.head == "catmlp+dpt":
            out1 = self.downstream_head1([outs1[k] for k in self.hooks], t1, d1, hw, (H, W))
            out2 = self.downstream_head2([outs2[k] for k in self.hooks], t2, d2, hw, (H, W))
        else:
            out1 = self.downstream_head1(d1, hw, (H, W))
            out2 = self.downstream_head2(d2, hw, (H, W))
        return out1, out2
