"""Tile binning: fixed-capacity, depth-sorted per-tile Gaussian lists.

Counterpart of ``gflow_tpu/ops/binning.py``:

1. every Gaussian emits a static MX x MY grid of candidate tiles covering
   its tile-rect (entries outside the rect get the sentinel tile T);
   two-class emission gives the largest splats the full grid and every
   other splat a small one;
2. one ``torch.sort`` orders packed int32 (tile, depth-bits) keys;
3. the tail (``bin_tail``) finds each tile's segment of the sorted stream
   and packs its first K ids into a dense (T, K) index matrix (-1 =
   empty): kernel K4 (``csrc/pack.cu``, one launch) on CUDA tensors, the
   plain searchsorted and masked gather on CPU tensors.

The index matrix is integer data; gradients flow through the values
gathered with it in the compositor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import TILE
from .tiles import _tile_rect


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

    def flat_keys(tile, dbits):
        return ((tile << depth_nbits) | dbits[:, None]).reshape(-1)

    two_class = (small_tiles_per_gaussian > 0
                 and _rect_grid_dims(small_tiles_per_gaussian) != (MX, MY))
    large_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    if not two_class:
        key_flat = flat_keys(_emit_candidates(uv, rect, MX, MY, visible, n_tx, T), depth_bits)
        idx_flat = MX * MY  # Gaussian j emits entries [j G, (j + 1) G)
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
        key_flat = torch.cat([flat_keys(tile_s, depth_bits),
                              flat_keys(tile_l, depth_bits[lidx])])
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        idx_flat = torch.cat([ids[:, None].expand_as(tile_s).reshape(-1),
                              lidx.to(torch.int32)[:, None].expand_as(tile_l).reshape(-1)])

    key_s, order = torch.sort(key_flat)
    tile_lists, tile_counts = bin_tail(key_s, order, idx_flat, depth_nbits, T, max_per_tile)
    return TileBins(tile_lists=tile_lists, tile_counts=tile_counts,
                    large_clamped=large_clamped)


def entry_ids(idx_flat, L: int, device) -> torch.Tensor:
    """The (L,) int32 Gaussian id of each emitted entry: idx_flat itself
    where it is an id array, j // G where it is a group size G (Gaussian j
    emitted entries [j G, (j + 1) G)), built as the single-class emission
    once built it: an arange over the Gaussians and an expand copy."""
    if not isinstance(idx_flat, int):
        return idx_flat
    ids = torch.arange(-(-L // idx_flat), dtype=torch.int32, device=device)
    return ids[:, None].expand(-1, idx_flat).reshape(-1)[:L]


def kernel_ids(idx_flat):
    """idx_flat as K4's C entry point takes it: (the id tensor, 1), or (0, G),
    a null id array, for a group size G."""
    return (0, idx_flat) if isinstance(idx_flat, int) else (idx_flat, 1)


def slot_bytes(idx_flat) -> int:
    """Bytes the tail must read per live slot: its entry of ``order``
    (int64) and, where idx_flat is an id array, the entry's id (int32)."""
    return 8 if isinstance(idx_flat, int) else 12


def bin_tail_plain(key_s, order, idx_flat, depth_nbits: int, T: int, K: int):
    """The tail of binning in plain PyTorch (see ``bin_tail``): the
    searchsorted segment starts (gflow_tpu/ops/binning.py:207), the counts,
    and the masked gather tile_lists[t, k] = idx_s[starts[t] + k] for
    k < tile_counts[t], else -1 (gflow_tpu/ops/binning.py:229-234), with
    idx_s = the ids in sorted order."""
    L, dev = key_s.shape[0], key_s.device
    starts = torch.searchsorted(key_s >> depth_nbits,
                                torch.arange(T + 1, dtype=torch.int32, device=dev),
                                side="left", out_int32=True)
    idx_s = entry_ids(idx_flat, L, dev)[order].to(torch.int32)
    pos = starts[:T, None] + torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    in_seg = pos < starts[1:, None]
    # one -1 past the end, so that L = 0 gathers too
    idx_s = torch.cat([idx_s, idx_s.new_full((1,), -1)])
    tile_lists = torch.where(in_seg, idx_s[pos.clamp_max(L).long()], -1).to(torch.int32)
    return tile_lists, starts[1:] - starts[:T]


def bin_tail(key_s, order, idx_flat, depth_nbits: int, T: int, K: int):
    """The tail of binning on any device: the plain version."""
    return bin_tail_plain(key_s, order, idx_flat, depth_nbits, T, K)
