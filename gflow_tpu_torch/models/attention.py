"""Plain attention, shared by the prior models (MASt3R's encoder and
decoder, SAM's image encoder and two-way mask decoder): matrix products
and a softmax, in the caller's precision (the models run it inside
``precision.fp32_math``)."""
from __future__ import annotations

import torch


def attend(q, k, v, bias=None):
    """(B, Nq, H, D), (B, Nk, H, D) x2 -> (B, Nq, H*D): softmax(scores +
    bias) v per head.

    Without `bias` the scores are q k^T / sqrt(D), the product scaled
    (MASt3R, SAM's mask decoder, as upstream). With `bias`, a contiguous
    (B, H, Nq, Nk) tensor that the call consumes, they are (q / sqrt(D))
    k^T, q scaled before the product (SAM's image encoder, as upstream),
    and the product is summed into `bias` by the GEMM itself: one pass
    over the scores where a scale and an add would take two more."""
    B, Nq, Hh, D = q.shape
    if bias is None:
        attn = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / D ** 0.5
    else:
        Nk = k.shape[1]
        attn = bias.view(B * Hh, Nq, Nk).baddbmm_(
            (q * D ** -0.5).transpose(1, 2).reshape(B * Hh, Nq, D),
            k.permute(0, 2, 3, 1).reshape(B * Hh, D, Nk)).view(B, Hh, Nq, Nk)
    out = torch.matmul(torch.softmax(attn, dim=-1), v.transpose(1, 2))
    return out.transpose(1, 2).reshape(B, Nq, Hh * D)
