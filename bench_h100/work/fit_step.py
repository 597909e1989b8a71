"""The least time of one full-stage iteration of the fit on the published
peaks (``harness.device``), part by part: the larger of its operations
over 67 TFLOP/s and its bytes over 3.35 TB/s for each part, summed.

- projection and its backward: per Gaussian of the capacity, 120
  operations forward (rotation to covariance, the 2D Jacobian, the conic,
  the radius) and twice that backward; the parameters it reads (xyz 3,
  scale 3, rotate 4) and its outputs (uv 2, depth 1, conic 3, radius 1),
  and backward the outputs' gradients read and the parameters' written;
- binning: the candidate keys of M tiles per Gaussian (int32) written and
  sorted (keys read, sorted keys and int64 order written), the tail
  reading each live slot's order entry, the tile lists and counts written;
- the compositor forward and backward (``work.composite``) over the
  (pixel, live slot) pairs of the step's own tile lists, F = 4 (rgb and
  depth);
- the losses and their backward: per pixel, the squared error (9), SSIM's
  five maps of 3 channels blurred by 11 taps in 2 passes (660) and its
  formula (60), the depth term (10), twice that backward; the render (4
  channels) and the targets (image 3, depth 1, flow 2, masks 2 bytes)
  read, the render's gradient written; per Gaussian 50 operations for the
  variance, scale, still and flow terms and their 12 floats read;
- gradient gating and Adam over the capacity's leaves (14 floats a
  Gaussian, 9 for pose and depth scale): gating 3 operations, a gradient
  read and written; Adam 12 operations, parameter, gradient and both
  moments read, parameter and moments written.

The tile lists come from the benchmark's frozen plain binning
(``reference/gs``) on the scene given, so the count reads the same work
whatever implements it."""
from __future__ import annotations

from harness.device import least_seconds

from . import composite as comp

PROJ_OPS_FWD = 120
LOSS_OPS_PIXEL = 9 + 660 + 60 + 10
LOSS_BYTES_PIXEL = 4 * 4 + 4 * (3 + 1 + 2) + 2 + 4 * 4
GAUSS_LEAVES = 3 + 3 + 4 + 1 + 3
FIXED_LEAVES = 7 + 2


def parts(capacity: int, pairs: int, live_slots: int, T: int, K: int, M: int, W: int,
          H: int, F: int = 4) -> dict:
    """{part: (operations, bytes)} of one full-stage iteration."""
    C, pixels = capacity, W * H
    L = C * M
    out = {
        "projection": (3.0 * PROJ_OPS_FWD * C,
                       4.0 * (C * 10 + C * 7) + 4.0 * (C * 6 + C * 10)),
        "binning": (0.0, 4.0 * L + (4.0 * L + 12.0 * L) + 8.0 * live_slots
                    + 4.0 * (T * K + T)),
        "composite_fwd": comp.forward(pairs, C, F, T, K, pixels),
        "composite_bwd": comp.backward(pairs, C, F, T, K, pixels),
        "losses": (3.0 * LOSS_OPS_PIXEL * pixels + 3.0 * 50 * C,
                   1.0 * LOSS_BYTES_PIXEL * pixels + 4.0 * 12 * C),
    }
    n = C * GAUSS_LEAVES + FIXED_LEAVES
    out["adam"] = (15.0 * n, 4.0 * (2 * n) + 4.0 * (4 * n + 3 * n))
    return out


def least_seconds_of(p: dict) -> float:
    return sum(least_seconds(ops, nbytes) for ops, nbytes in p.values())


def live_counts(tile_counts, K: int, W: int, H: int, tile: int = 16):
    """(live slots, in-image (pixel, live slot) pairs) of tile lists capped
    at K, tiles in row-major order over the padded grid."""
    import torch

    n_tx, n_ty = -(-W // tile), -(-H // tile)
    live = tile_counts.clamp_max(K).to(torch.int64)
    tx = torch.arange(n_tx, device=live.device).repeat(n_ty)
    ty = torch.arange(n_ty, device=live.device).repeat_interleave(n_tx)
    px = (W - tx * tile).clamp(max=tile)
    py = (H - ty * tile).clamp(max=tile)
    return int(live.sum()), int((live * px * py).sum())


def iteration_least_seconds(params, n_alive, intr, render_config, W: int, H: int) -> dict:
    """The least time of one full-stage iteration of the scene `params`
    (the program's Params, read only) seen from its own pose."""
    from reference.gs import stage as ref
    from reference.gs.binning import _rect_grid_dims, bin_gaussians
    from reference.gs.camera import pose_to_extr
    from reference.gs.projection import project_gaussians, supported_max_radius
    from reference.gs.state import Params

    p = Params(*params)
    scale, rotate, _, _ = ref.activate(p, n_alive)
    rc = render_config
    proj = project_gaussians(p.xyz, scale, rotate, intr, pose_to_extr(p.pose), W, H,
                             max_radius=supported_max_radius(rc.max_tiles_per_gaussian))
    bins = bin_gaussians(proj["uv"], proj["depth"], proj["radius"], W, H,
                         max_per_tile=rc.max_per_tile,
                         max_tiles_per_gaussian=rc.max_tiles_per_gaussian,
                         small_tiles_per_gaussian=rc.small_tiles_per_gaussian,
                         large_frac=rc.large_frac)
    live, pairs = live_counts(bins.tile_counts, rc.max_per_tile, W, H)
    MX, MY = _rect_grid_dims(rc.max_tiles_per_gaussian)
    T = bins.tile_counts.shape[0]
    pp = parts(p.capacity, pairs, live, T, rc.max_per_tile, MX * MY, W, H)
    return {"seconds": least_seconds_of(pp), "pairs": pairs, "live_slots": live,
            "parts": {k: least_seconds(*v) for k, v in pp.items()}}
