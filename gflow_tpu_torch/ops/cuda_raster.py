"""CUDA compositor for Hopper: forward kernels K1/K2, backward kernel K3.

Counterpart of ``gflow_tpu/ops/pallas_raster.py:127-549``. The kernels are
in ``csrc/composite.cu``. ``composite_tiles_kernel`` and
``composite_with_coverage_kernel`` have the signatures of
``composite_tiles_pallas`` / ``composite_with_coverage_pallas``, and their
``*_sharded`` twins those of the shard_map band wrappers:

- one wide row gather ``attrs[safe]`` builds the packed (T, K, CA) block,
  and autograd's transpose of that gather (``index_add_``) scatter-adds the
  per-slot gradients to the Gaussians;
- a ``torch.autograd.Function`` runs K1 (or K2) forward and K3 backward on
  the packed block; the background gets no gradient, as in ``_packed_bwd``;
- the band wrappers split the packed block by tile rows into one band per
  device, composite each band on its device at its tile-row offset and
  bring the band images back; autograd carries each band's per-slot
  gradients back into disjoint rows of the block's gradient, which the
  gather's transpose sums per Gaussian (the counterpart of shard_map's
  psum).

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


def composite_fwd(g_attrs, counts, bg, n_tx: int, with_cov: bool = False, row0: int = 0):
    """Launch K1 (with_cov False) or K2 (True) on CUDA tensors whose tiles
    start at tile row row0. Returns out (T, P, F) and, with_cov, the
    coverage (T, P, 1)."""
    T, K, CA = g_attrs.shape
    F = CA - 6 - int(with_cov)
    _check_packed(g_attrs, counts, bg, F)
    out = torch.empty((T, P_PIX, F), dtype=torch.float32, device=g_attrs.device)
    if not with_cov:
        _build.launch("composite_fwd", counts, g_attrs, bg, out, T, K, CA, F, n_tx, row0)
        return out
    cov = torch.empty((T, P_PIX, 1), dtype=torch.float32, device=g_attrs.device)
    _build.launch("composite_fwd_cov", counts, g_attrs, bg, out, cov, T, K, CA, F, n_tx, row0)
    return out, cov


def composite_bwd(g_attrs, counts, bg, g, n_tx: int, with_cov: bool = False, row0: int = 0):
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
    _build.launch("composite_bwd", counts, g_attrs, bg, g, dattrs, T, K, CA, F, n_tx, row0)
    return dattrs


class _PackedComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g_attrs, counts, bg, n_tx, with_cov, row0):
        ctx.save_for_backward(g_attrs, counts, bg)
        ctx.n_tx, ctx.with_cov, ctx.row0 = n_tx, with_cov, row0
        res = composite_fwd(g_attrs, counts, bg, n_tx, with_cov, row0)
        if with_cov:
            ctx.mark_non_differentiable(res[1])
        return res

    @staticmethod
    def backward(ctx, g_out, *unused):
        g_attrs, counts, bg = ctx.saved_tensors
        dattrs = composite_bwd(g_attrs, counts, bg, g_out, ctx.n_tx, ctx.with_cov, ctx.row0)
        return dattrs, None, None, None, None, None


def packed_composite(g_attrs, counts, bg, n_tx: int, with_cov: bool = False, row0: int = 0):
    """The packed compositor (T, K, CA) -> (T, P, F) (and the coverage, with
    with_cov) for the device of g_attrs, its tiles starting at tile row
    row0: K1 or K2 forward and K3 backward on a CUDA tensor, the plain
    ``composite.composite_packed`` (autograd backward) on a CPU tensor."""
    if g_attrs.device.type == "cpu":
        return composite_packed(g_attrs, counts, bg, n_tx, with_cov, row0)
    return _PackedComposite.apply(g_attrs, counts, bg, n_tx, with_cov, row0)


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


def band_rows(tile_lists, tile_counts, n_tx: int, n_ty: int, D: int):
    """Pad the tile rows to a multiple of D with empty tiles (list -1,
    count 0); returns (lists, counts or None, rows per band). Counterpart
    of ``_shard_setup``."""
    n_ty_pad = -(-n_ty // D) * D
    pad = (n_ty_pad - n_ty) * n_tx
    if pad:
        tile_lists = torch.cat([tile_lists, tile_lists.new_full((pad, tile_lists.shape[1]), -1)])
        if tile_counts is not None:
            tile_counts = torch.cat([tile_counts, tile_counts.new_zeros(pad)])
    return tile_lists, tile_counts, n_ty_pad // D


# (bg value, F, device) -> the (F,) background on that device: a band's
# constant, made once, so that a stage's graph replays no copy of it
_BAND_BG: dict = {}


def band_bg(bg, F: int, dev: torch.device):
    """The (F,) float32 background of a band on `dev`: a Python number's
    is made once per device and kept (no copy in a replay); a tensor's is
    copied."""
    if not isinstance(bg, (int, float)):
        return bg_vector(bg, F, dev)
    key = (float(bg), F, dev)
    if key not in _BAND_BG:
        _BAND_BG[key] = bg_vector(float(bg), F, dev)
    return _BAND_BG[key]


def band_composite(g_attrs, counts, bg, n_tx: int, rows_per: int, band_devices,
                   with_cov: bool = False):
    """The packed compositor over bands: band b (rows_per tile rows, from
    tile row b * rows_per) goes to band_devices[b] and composites there in
    place (the kernels' row0, where the JAX wrapper shifts uv.y by the
    band's pixel origin in float32); the band outputs come back to
    g_attrs' device in order. bg is a number or an (F,) tensor (band_bg).
    The split's transpose concatenates the bands' per-slot gradients into
    the block's gradient."""
    home = g_attrs.device
    F = g_attrs.shape[2] - 6 - int(with_cov)
    T_b = rows_per * n_tx
    outs, covs = [], []
    for b, (blk, cnt, dev) in enumerate(zip(g_attrs.split(T_b), counts.split(T_b),
                                            band_devices)):
        dev = torch.device(dev)
        res = packed_composite(blk.to(dev), cnt.to(dev), band_bg(bg, F, dev), n_tx, with_cov,
                               row0=b * rows_per)
        out, cov = res if with_cov else (res, None)
        outs.append(out.to(home))
        if with_cov:
            covs.append(cov.to(home))
    out = torch.cat(outs)
    return (out, torch.cat(covs)) if with_cov else out


def composite_tiles_kernel_sharded(tile_lists, uv, conic, opacity, features, bg, W: int,
                                   H: int, n_tx: int, n_ty: int, band_devices,
                                   tile_counts=None):
    """composite_tiles_kernel with the tile rows in len(band_devices) bands,
    one per device (``composite_tiles_pallas_sharded``): the gather builds
    the packed block on uv's device, each band runs K1 forward and K3
    backward on its own device (the plain version on a CPU band), and the
    image comes back to uv's device. Differentiable as the unbanded call."""
    lists, counts, rows_per = band_rows(tile_lists, tile_counts, n_tx, n_ty,
                                        len(band_devices))
    attrs = torch.cat([uv, conic, opacity, features], dim=1)
    g_attrs, counts = pack_attrs(lists, counts, attrs)
    out = band_composite(g_attrs, counts, bg, n_tx, rows_per, band_devices)
    return untile(out, n_tx, rows_per * len(band_devices), W, H)


def composite_with_coverage_kernel_sharded(tile_lists, uv, conic, opacity, features, mov,
                                           bg, W: int, H: int, n_tx: int, n_ty: int,
                                           band_devices, tile_counts=None):
    """The banded twin of composite_with_coverage_kernel
    (``composite_with_coverage_pallas_sharded``): K2 forward per band."""
    lists, counts, rows_per = band_rows(tile_lists, tile_counts, n_tx, n_ty,
                                        len(band_devices))
    attrs = torch.cat([uv, conic, opacity, features, mov], dim=1)
    g_attrs, counts = pack_attrs(lists, counts, attrs)
    out, cov = band_composite(g_attrs, counts, bg, n_tx, rows_per, band_devices, with_cov=True)
    n_ty_pad = rows_per * len(band_devices)
    return untile(out, n_tx, n_ty_pad, W, H), untile(cov, n_tx, n_ty_pad, W, H)
