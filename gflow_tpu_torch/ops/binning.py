"""Tile binning: fixed-capacity, depth-sorted per-tile Gaussian lists.

Counterpart of ``gflow_tpu/ops/binning.py``:

1. every Gaussian emits a static MX x MY grid of candidate tiles covering
   its tile-rect (entries outside the rect get the sentinel tile T);
   two-class emission gives the largest splats the full grid and every
   other splat a small one;
2. one ``torch.sort`` orders packed int32 (tile, depth-bits) keys;
3. per-tile starts come from ``torch.searchsorted`` over the sorted tiles;
4. the first K entries of each tile are packed into a dense (T, K) index
   matrix (-1 = empty) — kernel K4 (``csrc/pack.cu``) on CUDA tensors, the
   plain masked gather on CPU tensors.

The index matrix is integer data; gradients flow through the values
gathered with it in the compositor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .projection import TILE
from .reference import _tile_rect


class TileBins(NamedTuple):
    tile_lists: torch.Tensor     # (T, K) int32 gaussian indices, -1 = empty
    tile_counts: torch.Tensor    # (T,) int32 valid entries (uncapped count)
    # two-class telemetry: splats classed large but beyond the n_large cap
    large_clamped: torch.Tensor | None = None


def tile_grid(W: int, H: int) -> tuple[int, int]:
    return -(-W // TILE), -(-H // TILE)


def _rect_grid_dims(max_tiles_per_gaussian: int) -> tuple[int, int]:
    """Static (MX, MY) candidate grid with MX a power of two."""
    m = max(4, max_tiles_per_gaussian)
    if m >= 64:
        return 8, 8
    if m >= 48:
        return 8, 6
    if m >= 32:
        return 8, 4
    if m >= 16:
        return 4, 4
    if m >= 12:
        return 4, 3
    return 4, 2


def _emit_candidates(uv, rect, MX: int, MY: int, emit_mask, n_tx: int, T: int):
    """(n, MX*MY) int32 tile ids of each point's candidate grid, centered on
    the point's own tile and clamped into its rect (coverage of an
    oversized splat is lost symmetrically at the far corners); sentinel T
    where out-of-rect or emit_mask is False."""
    rminx, rmaxx, rminy, rmaxy = rect
    cx = torch.floor(uv[:, 0] / TILE - (MX - 1) / 2).to(torch.int32)
    cy = torch.floor(uv[:, 1] / TILE - (MY - 1) / 2).to(torch.int32)
    gx0 = torch.minimum(torch.maximum(cx, rminx), torch.maximum(rmaxx - MX, rminx))
    gy0 = torch.minimum(torch.maximum(cy, rminy), torch.maximum(rmaxy - MY, rminy))
    j = torch.arange(MX * MY, dtype=torch.int32, device=uv.device)[None, :]
    tx = gx0[:, None] + (j % MX)
    ty = gy0[:, None] + torch.div(j, MX, rounding_mode="floor")
    valid = (tx < rmaxx[:, None]) & (ty < rmaxy[:, None]) & emit_mask[:, None]
    return torch.where(valid, ty * n_tx + tx, T).to(torch.int32)


@torch.no_grad()
def bin_gaussians(uv, depth, radius, W: int, H: int, max_per_tile: int = 256,
                  max_tiles_per_gaussian: int = 32,
                  small_tiles_per_gaussian: int = 0,
                  large_frac: float = 0.125) -> TileBins:
    """Build depth-sorted per-tile lists from one global packed-key sort.

    small_tiles_per_gaussian > 0 enables two-class emission: every splat
    emits the small grid, except the (at most large_frac * N) splats whose
    tile-rect exceeds it, largest area first, which emit the full
    max_tiles_per_gaussian grid. Splats classed large beyond the cap fall
    back to the small grid (counted in large_clamped)."""
    uv, depth, radius = uv.detach(), depth.detach(), radius.detach()
    N = uv.shape[0]
    dev = uv.device
    MX, MY = _rect_grid_dims(max_tiles_per_gaussian)
    n_tx, n_ty = tile_grid(W, H)
    T = n_tx * n_ty

    visible = depth[:, 0] > 0
    rect = _tile_rect(uv, radius, n_tx, n_ty)

    # ONE int32 sort key: tile in the high bits, the top bits of the
    # positive-float depth below (positive IEEE floats are order-isomorphic
    # to their bit patterns); the quantization only permutes near-equal
    # depths
    tile_bits = max((T + 1).bit_length(), 1)
    depth_nbits = 31 - tile_bits
    if depth_nbits < 12:
        raise ValueError(f"too many tiles ({T}) for int32 packed sort keys")
    depth_bits = depth[:, 0].clamp_min(0.0).contiguous().view(torch.int32) >> (
        31 - depth_nbits)
    ids = torch.arange(N, dtype=torch.int32, device=dev)

    def flat_keys(tile, dbits, idx):
        key = (tile << depth_nbits) | dbits[:, None]
        return key.reshape(-1), idx[:, None].expand_as(tile).reshape(-1)

    two_class = (small_tiles_per_gaussian > 0
                 and _rect_grid_dims(small_tiles_per_gaussian) != (MX, MY))
    large_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    if not two_class:
        tile = _emit_candidates(uv, rect, MX, MY, visible, n_tx, T)
        key_flat, idx_flat = flat_keys(tile, depth_bits, ids)
    else:
        MXs, MYs = _rect_grid_dims(small_tiles_per_gaussian)
        rminx, rmaxx, rminy, rmaxy = rect
        rw = rmaxx - rminx
        rh = rmaxy - rminy
        is_large = visible & ((rw > MXs) | (rh > MYs))
        n_large = min(N, max(8, int(round(N * large_frac))))
        score = torch.where(is_large, rw * rh, 0).to(torch.int32)
        lidx = torch.sort(-score, stable=True).indices[:n_large]
        selected = score[lidx] > 0
        in_large = torch.zeros(N, dtype=torch.bool, device=dev)
        in_large[lidx] = selected
        large_clamped = torch.sum(is_large & ~in_large).to(torch.int32)

        tile_s = _emit_candidates(uv, rect, MXs, MYs, visible & ~in_large, n_tx, T)
        rect_l = tuple(r[lidx] for r in rect)
        tile_l = _emit_candidates(uv[lidx], rect_l, MX, MY, selected, n_tx, T)
        ks, is_ = flat_keys(tile_s, depth_bits, ids)
        kl, il = flat_keys(tile_l, depth_bits[lidx], lidx.to(torch.int32))
        key_flat = torch.cat([ks, kl])
        idx_flat = torch.cat([is_, il])

    key_s, order = torch.sort(key_flat)
    idx_s = idx_flat[order].contiguous()
    tile_s = key_s >> depth_nbits
    starts = torch.searchsorted(
        tile_s, torch.arange(T + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True)  # starts[T] = first sentinel position
    tile_counts = starts[1:] - starts[:T]
    tile_lists = pack_tile_lists(idx_s, starts[:T].contiguous(), tile_counts,
                                 max_per_tile)
    return TileBins(tile_lists=tile_lists, tile_counts=tile_counts,
                    large_clamped=large_clamped)


def pack_tile_lists_plain(idx_s, starts, tile_counts, K: int) -> torch.Tensor:
    """tile_lists[t, k] = idx_s[starts[t] + k] for k < tile_counts[t], else -1
    (the masked gather of gflow_tpu/ops/binning.py:229-234)."""
    L = idx_s.shape[0]
    pos = starts[:, None] + torch.arange(K, dtype=torch.int32, device=idx_s.device)[None, :]
    in_seg = pos < (starts + tile_counts)[:, None]
    pos = pos.clamp_max(L - 1).long()
    return torch.where(in_seg, idx_s[pos], -1).to(torch.int32)


def pack_tile_lists(idx_s, starts, tile_counts, K: int) -> torch.Tensor:
    """Kernel K4 on CUDA tensors (replaces the Pallas
    ``_rotate_pack_kernel``); the plain gather on CPU tensors."""
    if not idx_s.is_cuda:
        return pack_tile_lists_plain(idx_s, starts, tile_counts, K)
    T = starts.shape[0]
    for name, x in (("idx_s", idx_s), ("starts", starts), ("tile_counts", tile_counts)):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != idx_s.device:
            raise ValueError(f"{name}: need a contiguous int32 tensor on {idx_s.device}")
    out = torch.empty((T, K), dtype=torch.int32, device=idx_s.device)
    _build.launch("pack_tile_lists", idx_s, starts, tile_counts, out, T, K)
    return out
