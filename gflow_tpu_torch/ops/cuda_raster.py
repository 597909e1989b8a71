"""CUDA compositor for Hopper: forward kernels K1/K2, backward kernel K3.

Counterpart of ``gflow_tpu/ops/pallas_raster.py:127-429`` (the
``*_sharded`` band wrappers belong to the multi-GPU slice). The kernels are
in ``csrc/composite.cu``. ``composite_tiles_kernel`` and
``composite_with_coverage_kernel`` have the signatures of
``composite_tiles_pallas`` / ``composite_with_coverage_pallas``:

- one wide row gather ``attrs[safe]`` builds the packed (T, K, CA) block,
  and autograd's transpose of that gather (``index_add_``) scatter-adds the
  per-slot gradients to the Gaussians;
- a ``torch.autograd.Function`` runs K1 (or K2) forward and K3 backward on
  the packed block; the background gets no gradient, as in ``_packed_bwd``.

``packed_composite`` picks the packed call by device: a CPU tensor takes the
plain version ``composite.composite_packed``, any other launches the kernel
or raises; nothing falls back.
"""
from __future__ import annotations

import torch

from . import _build
from .composite import P_PIX, bg_vector, composite_packed, pack_attrs, untile


def _check_packed(g_attrs, counts, bg, F: int):
    T, K, CA = g_attrs.shape
    dev = g_attrs.device
    if g_attrs.dtype != torch.float32 or not g_attrs.is_contiguous():
        raise ValueError("g_attrs: need a contiguous float32 (T, K, CA) tensor")
    if counts.dtype != torch.int32 or counts.shape != (T,) or not counts.is_contiguous():
        raise ValueError("counts: need a contiguous int32 (T,) tensor")
    if bg.dtype != torch.float32 or bg.shape != (F,) or not bg.is_contiguous():
        raise ValueError(f"bg: need a contiguous float32 ({F},) tensor")
    if not (1 <= F <= 8):
        raise ValueError(f"the CUDA compositor takes 1 to 8 feature channels, got {F}")
    if counts.device != dev or bg.device != dev:
        raise ValueError("g_attrs, counts and bg must be on one device")


def composite_fwd(g_attrs, counts, bg, n_tx: int, with_cov: bool = False):
    """Launch K1 (with_cov False) or K2 (True) on CUDA tensors. Returns out
    (T, P, F) and, with_cov, the coverage (T, P, 1)."""
    T, K, CA = g_attrs.shape
    F = CA - 6 - int(with_cov)
    _check_packed(g_attrs, counts, bg, F)
    out = torch.empty((T, P_PIX, F), dtype=torch.float32, device=g_attrs.device)
    if not with_cov:
        _build.launch("composite_fwd", counts, g_attrs, bg, out, T, K, CA, F, n_tx)
        return out
    cov = torch.empty((T, P_PIX, 1), dtype=torch.float32, device=g_attrs.device)
    _build.launch("composite_fwd_cov", counts, g_attrs, bg, out, cov, T, K, CA, F, n_tx)
    return out, cov


def composite_bwd(g_attrs, counts, bg, g, n_tx: int, with_cov: bool = False):
    """Launch K3 on CUDA tensors: per-slot gradients (T, K, CA) of
    sum(out * g) w.r.t. g_attrs, for the upstream gradient g (T, P, F)."""
    T, K, CA = g_attrs.shape
    F = CA - 6 - int(with_cov)
    _check_packed(g_attrs, counts, bg, F)
    if g.dtype != torch.float32 or g.shape != (T, P_PIX, F) or g.device != g_attrs.device:
        raise ValueError(f"g: need a float32 ({T}, {P_PIX}, {F}) tensor")
    g = g.contiguous()
    if g.data_ptr() % 16:  # the kernel reads each thread's 4F floats as float4s
        g = g.clone()
    dattrs = torch.empty_like(g_attrs)
    _build.launch("composite_bwd", counts, g_attrs, bg, g, dattrs, T, K, CA, F, n_tx)
    return dattrs


class _PackedComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g_attrs, counts, bg, n_tx, with_cov):
        ctx.save_for_backward(g_attrs, counts, bg)
        ctx.n_tx, ctx.with_cov = n_tx, with_cov
        res = composite_fwd(g_attrs, counts, bg, n_tx, with_cov)
        if with_cov:
            ctx.mark_non_differentiable(res[1])
        return res

    @staticmethod
    def backward(ctx, g_out, *unused):
        g_attrs, counts, bg = ctx.saved_tensors
        dattrs = composite_bwd(g_attrs, counts, bg, g_out, ctx.n_tx, ctx.with_cov)
        return dattrs, None, None, None, None


def packed_composite(g_attrs, counts, bg, n_tx: int, with_cov: bool = False):
    """The packed compositor (T, K, CA) -> (T, P, F) (and the coverage, with
    with_cov) for the device of g_attrs: K1 or K2 forward and K3 backward
    on a CUDA tensor, the plain ``composite.composite_packed`` (autograd
    backward) on a CPU tensor."""
    if g_attrs.device.type == "cpu":
        return composite_packed(g_attrs, counts, bg, n_tx, with_cov)
    return _PackedComposite.apply(g_attrs, counts, bg, n_tx, with_cov)


def composite_tiles_kernel(tile_lists, uv, conic, opacity, features, bg, W: int,
                           H: int, n_tx: int, n_ty: int, tile_counts=None):
    """Composited image (H, W, F), differentiable w.r.t. uv / conic /
    opacity / features."""
    attrs = torch.cat([uv, conic, opacity, features], dim=1)
    g_attrs, counts = pack_attrs(tile_lists, tile_counts, attrs)
    bg = bg_vector(bg, features.shape[1], uv.device)
    return untile(packed_composite(g_attrs, counts, bg, n_tx), n_tx, n_ty, W, H)


def composite_with_coverage_kernel(tile_lists, uv, conic, opacity, features, mov,
                                   bg, W: int, H: int, n_tx: int, n_ty: int,
                                   tile_counts=None):
    """Camera-only stage path: the moving coverage max_k(alpha_k * mov_k)
    rides the main forward as a second output, from the same alphas; mov is
    a (N, 1) 0/1 column. Returns (img (H, W, F), coverage (H, W, 1)); the
    coverage carries no gradient."""
    attrs = torch.cat([uv, conic, opacity, features, mov], dim=1)
    g_attrs, counts = pack_attrs(tile_lists, tile_counts, attrs)
    bg = bg_vector(bg, features.shape[1], uv.device)
    out, cov = packed_composite(g_attrs, counts, bg, n_tx, with_cov=True)
    return untile(out, n_tx, n_ty, W, H), untile(cov, n_tx, n_ty, W, H)
