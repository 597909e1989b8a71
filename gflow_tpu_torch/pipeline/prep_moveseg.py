"""Epipolar motion-mask preparation.

Counterpart of ``gflow_tpu/pipeline/prep_moveseg.py`` (the reference's
utility/move_seg.py): per consecutive frame pair, the forward flow gives
correspondences on a [-1, 1]-normalized grid; a robust fundamental matrix
is fit (LMedS, ``ops.epipolar``, on the card); the per-pixel squared
Sampson error, scaled by ((H + W) / 2)^2 and normalized by its max, is
thresholded into a moving-region mask, written with its open / erode /
dilate variants (SciPy disks of radius 2, 5, 3 on the host) into
``<seq>_epipolar/``. Runs on ``cuda`` unless the caller passes
``device="cpu"``. CLI: ``python -m gflow_tpu_torch.cli.prep_moveseg``.

``main`` records into the process's telemetry (``utils.profiling.current``)
the phase ``prep_moveseg`` and, per pair, its pieces ``prep_moveseg/read``
(the ``.flo`` read), ``prep_moveseg/lmeds`` (the error map, ending in its
pull to the host, which waits for the card), ``prep_moveseg/morph`` (the
threshold and SciPy's morphology) and ``prep_moveseg/write`` (four PNGs).
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.io import imwrite, read_flow
from ..ops.epipolar import find_fundamental_lmeds, sampson_error
from ..utils import profiling
from ..viz.colormap import print_color
from .prep_flow import list_frames


def _disk(radius: int) -> np.ndarray:
    yy, xx = np.ogrid[-radius: radius + 1, -radius: radius + 1]
    return (xx * xx + yy * yy) <= radius * radius


def uv_grid(H: int, W: int) -> np.ndarray:
    """(H, W, 2) grid normalized to (-1, 1), pixel-center convention
    (align_corners=False)."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack([2 * (xx + 0.5) / W - 1, 2 * (yy + 0.5) / H - 1], axis=-1)


def epipolar_error_map(flow: np.ndarray, generator: torch.Generator | None = None,
                       device=None, draws=None) -> np.ndarray:
    """Forward flow (H, W, 2) in pixels -> normalized epipolar error map
    (H, W) in [0, 1], as NumPy. The LMedS runs on `device` (default: the
    card) and draws from `generator` (default: seed 0), or takes `draws`
    (see ops.epipolar.find_fundamental_lmeds)."""
    dev = resolve_device(device)
    H, W = flow.shape[:2]
    x1 = uv_grid(H, W).reshape(-1, 2)
    flow_norm = np.stack([2.0 * flow[..., 0] / (W - 1), 2.0 * flow[..., 1] / (H - 1)],
                         axis=-1).reshape(-1, 2)
    x1 = torch.from_numpy(x1).to(dev)
    x2 = x1 + torch.from_numpy(np.ascontiguousarray(flow_norm, np.float32)).to(dev)
    F, _ = find_fundamental_lmeds(x1, x2, generator, draws=draws)
    err = (sampson_error(x1, x2, F).reshape(H, W) * ((H + W) / 2) ** 2).cpu().numpy()
    return err / max(err.max(), 1e-12)


def main(img_dir: str, threshold: float = 0.01, device: Optional[str] = None):
    with profiling.current().phase("prep_moveseg"):
        return _main(img_dir, threshold, device)


def _main(img_dir, threshold, device):
    from scipy.ndimage import binary_dilation, binary_erosion, binary_opening

    phase = profiling.current().phase
    img_dir = str(img_dir)
    flow_dir = img_dir + "_flow_unimatch"
    epi_dir = img_dir + "_epipolar"
    os.makedirs(epi_dir, exist_ok=True)

    image_paths = list_frames(img_dir)
    fwd_paths = sorted(glob.glob(os.path.join(flow_dir, "*_pred.flo")))
    if not fwd_paths:
        raise FileNotFoundError(f"no forward flows under {flow_dir}")

    for idx, fp in enumerate(fwd_paths):
        with phase("prep_moveseg/read"):
            flow = read_flow(fp)
        with phase("prep_moveseg/lmeds"):
            err = epipolar_error_map(flow, device=device)
        with phase("prep_moveseg/morph"):
            mask = err > threshold
            mask_open = binary_opening(mask, structure=_disk(2))
            mask_erode = binary_erosion(mask, structure=_disk(5))
            mask_dilate = binary_dilation(mask, structure=_disk(3))
        with phase("prep_moveseg/write"):
            name = os.path.splitext(os.path.basename(image_paths[idx]))[0]
            imwrite(os.path.join(epi_dir, f"{name}_epipolar_error.png"),
                    (err * 255).astype(np.uint8))
            for tag, m in (("open", mask_open), ("erode", mask_erode), ("dilate", mask_dilate)):
                imwrite(os.path.join(epi_dir, f"{name}_{tag}.png"), (m * 255).astype(np.uint8))
            print_color(f"[move_seg] {name}: moving ratio "
                        f"{mask.mean():.4f} -> open {mask_open.mean():.4f}")
    return epi_dir
