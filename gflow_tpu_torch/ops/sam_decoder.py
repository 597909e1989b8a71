"""The image stream of SAM's two-way mask decoder (``csrc/sam_decoder.cu``).

The decoder's image side is kept as (B, N, C) token rows, N = h * w image
tokens of C channels for each of B prompts. Between its projections (plain
``F.linear`` GEMMs) four functions do the rest of the work:

- ``stream_init``: the embedding, (1, C, h, w) repeated per prompt or
  (B, C, h, w) one a prompt, plus the dense prompt, (C,) at every cell or
  (B, C, h, w) one a cell, as rows: ``keys``; and ``kpe = keys + key_pe``,
  with key_pe the (N, C) token-major positional encoding;
- ``t2i_attend``: token to image, softmax((q k^T) / sqrt(d)) v per head for
  q (B, T, I) and k, v (B, N, I), merged heads (B, T, I);
- ``i2t_attend``: image to token, the same for q (B, N, I) and k, v
  (B, T, I): (B, N, I);
- ``residual_ln``: ``keys = LayerNorm(keys + out)`` and ``kpe = keys +
  key_pe``, the next attention's keys made once.

Each has a plain version, the decoder's formula before these kernels
(upstream's ``transformer.py``) op for op, which a CPU tensor takes. A
tensor on any other device launches the kernel or raises; nothing falls
back. The kernels take contiguous float32 tensors at the widths of SAM's
released decoders: C = 256 (``stream_init`` any multiple of 32), I = 128
in 8 heads of 16, 1 <= T <= 8, N a multiple of 32 for ``stream_init``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.attention import attend
from . import _build

WIDTH = 256      # the image stream's C (residual_ln)
INNER = 128      # the cross attentions' width
HEADS = 8        # of INNER // HEADS = 16
MAX_TOKENS = 8
TILE = 32        # stream_init's tile: N and C multiples of it
CHUNK = 256      # image rows a block of the attentions (csrc kChunk)


def stream_init_plain(image, dense, key_pe, B: int):
    """(keys, kpe) (B, N, C): image (1 or B, C, h, w) expanded to B prompts
    plus dense, (C,) at every cell or (B, C, h, w), flattened to token rows
    (a strided view), and keys + key_pe (N, C)."""
    d = dense.reshape(1, -1, 1, 1) if dense.dim() == 1 else dense
    keys = (image.expand(B, -1, -1, -1) + d).flatten(2).permute(0, 2, 1)
    return keys, keys + key_pe


def cross_attend_plain(q, k, v, heads: int):
    """Attention of q (B, Nq, I) over k, v (B, Nk, I) in `heads` heads, the
    scores (q k^T) / sqrt(I / heads): the plain version of both
    ``t2i_attend`` and ``i2t_attend``."""
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1)
    return attend(split(q), split(k), split(v))


def residual_ln_plain(keys, out, weight, bias, eps: float, key_pe):
    """(LayerNorm(keys + out), it + key_pe)."""
    keys = F.layer_norm(keys + out, (keys.shape[-1],), weight, bias, eps)
    return keys, keys + key_pe


def _check(fn: str, name: str, t: torch.Tensor, shape) -> None:
    shape = tuple(shape)
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must be float32 of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def _check_tokens(fn: str, T: int, heads: int) -> None:
    if not 1 <= T <= MAX_TOKENS or heads != HEADS:
        raise ValueError(f"{fn}: the kernel takes 1 to {MAX_TOKENS} tokens in {HEADS} heads, "
                         f"got {T} tokens in {heads}")


def stream_init_kernel(image, dense, key_pe, B: int):
    """``stream_init`` through the ``sam_stream_init`` kernel: contiguous
    (B, N, C) keys and kpe."""
    if image.dim() != 4 or image.shape[0] not in (1, B):
        raise ValueError(f"stream_init: image must be (1, C, h, w) or ({B}, C, h, w), got "
                         f"{tuple(image.shape)}")
    b, C, h, w = image.shape
    N = h * w
    if C % TILE or N % TILE or B < 1:
        raise ValueError(f"stream_init: the kernel takes C and h * w multiples of {TILE} and "
                         f"B >= 1, got C {C}, h * w {N}, B {B}")
    cells = dense.dim() != 1
    _check("stream_init", "image", image, (b, C, h, w))
    _check("stream_init", "dense", dense, (B, C, h, w) if cells else (C,))
    _check("stream_init", "key_pe", key_pe, (N, C))
    keys = torch.empty((B, N, C), dtype=torch.float32, device=image.device)
    kpe = torch.empty_like(keys)
    _build.launch("sam_stream_init", image, dense, key_pe, N, C, B, int(b > 1), int(cells),
                  keys, kpe)
    return keys, kpe


def t2i_attend_kernel(q, k, v, heads: int):
    """``t2i_attend`` through the ``sam_t2i_attend`` kernels: (B, T, I)."""
    B, T, _ = q.shape
    N = k.shape[1]
    _check_tokens("t2i_attend", T, heads)
    _check("t2i_attend", "q", q, (B, T, INNER))
    _check("t2i_attend", "k", k, (B, N, INNER))
    _check("t2i_attend", "v", v, (B, N, INNER))
    S = -(-N // CHUNK)
    part_acc = torch.empty((B, S, T, INNER), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, S, T, HEADS, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, T, INNER), dtype=torch.float32, device=q.device)
    _build.launch("sam_t2i_attend", q, k, v, B, T, N, part_acc, part_ml, out)
    return out


def i2t_attend_kernel(q, k, v, heads: int):
    """``i2t_attend`` through the ``sam_i2t_attend`` kernel: (B, N, I)."""
    B, N, _ = q.shape
    T = k.shape[1]
    _check_tokens("i2t_attend", T, heads)
    _check("i2t_attend", "q", q, (B, N, INNER))
    _check("i2t_attend", "k", k, (B, T, INNER))
    _check("i2t_attend", "v", v, (B, T, INNER))
    out = torch.empty((B, N, INNER), dtype=torch.float32, device=q.device)
    _build.launch("sam_i2t_attend", q, k, v, B, T, N, out)
    return out


def residual_ln_kernel(keys, out, weight, bias, eps: float, key_pe):
    """``residual_ln`` through the ``sam_residual_ln`` kernel."""
    B, N, _ = keys.shape
    for name, t, shape in (("keys", keys, (B, N, WIDTH)), ("out", out, (B, N, WIDTH)),
                           ("weight", weight, (WIDTH,)), ("bias", bias, (WIDTH,)),
                           ("key_pe", key_pe, (N, WIDTH))):
        _check("residual_ln", name, t, shape)
    new = torch.empty_like(keys)
    new_pe = torch.empty_like(keys)
    _build.launch("sam_residual_ln", keys, out, weight, bias, key_pe, B, N, float(eps), new,
                  new_pe)
    return new, new_pe


def stream_init(image, dense, key_pe, B: int):
    """(keys, kpe) (B, N, C) of the embedding `image` (1 or B, C, h, w),
    the dense prompt `dense` ((C,) or (B, C, h, w)) and the token-major PE
    `key_pe` (N, C)."""
    if image.device.type == "cpu":
        return stream_init_plain(image, dense, key_pe, B)
    return stream_init_kernel(image, dense, key_pe, B)


def t2i_attend(q, k, v, heads: int):
    """Token to image: q (B, T, I) over k, v (B, N, I) -> (B, T, I)."""
    if q.device.type == "cpu":
        return cross_attend_plain(q, k, v, heads)
    return t2i_attend_kernel(q, k, v, heads)


def i2t_attend(q, k, v, heads: int):
    """Image to token: q (B, N, I) over k, v (B, T, I) -> (B, N, I)."""
    if q.device.type == "cpu":
        return cross_attend_plain(q, k, v, heads)
    return i2t_attend_kernel(q, k, v, heads)


def residual_ln(keys, out, weight, bias, eps: float, key_pe):
    """(LayerNorm(keys + out) with `weight`, `bias`, `eps`; it + key_pe),
    each (B, N, C)."""
    if keys.device.type == "cpu":
        return residual_ln_plain(keys, out, weight, bias, eps, key_pe)
    return residual_ln_kernel(keys, out, weight, bias, eps, key_pe)
