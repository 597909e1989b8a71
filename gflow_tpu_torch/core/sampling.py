"""Gradient-magnitude importance sampling for Gaussian initialization.

Host-side NumPy/SciPy, a copy of ``gflow_tpu/core/sampling.py`` (which
mirrors gflow/utils/complex_texture_sampling.py:4-46): Sobel gradient
magnitude of the grayscale image -> probability map -> categorical pixel
sampling; scales inversely proportional to probability, normalized to sum
100. Sobel-3 with reflect-101 borders is scipy.ndimage.sobel(mode='mirror').
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def gradient_probability_map(image01: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0,1] -> (H, W) probability map over pixels."""
    img255 = image01 * 255.0
    gray = 0.299 * img255[..., 0] + 0.587 * img255[..., 1] + 0.114 * img255[..., 2]
    gx = ndimage.sobel(gray, axis=1, mode="mirror")
    gy = ndimage.sobel(gray, axis=0, mode="mirror")
    mag = np.sqrt(gx * gx + gy * gy)
    nonzero = mag[mag > 0]
    mag = mag + (nonzero.min() if nonzero.size else 1.0)
    return mag / mag.sum()


def complex_texture_sampling(
    gt_image: np.ndarray,   # (H, W, 3) float [0, 1]
    gt_depth: np.ndarray,   # (H, W)
    num_points: int = 5000,
    mask: np.ndarray | None = None,
    drop_to: int | None = None,
    rng: np.random.Generator | None = None,
):
    """Returns (xys (M,2) pixel xy, depths (M,), scales (M,), rgbs (M,3))."""
    if rng is None:
        rng = np.random.default_rng()
    H, W = gt_image.shape[:2]
    prob = gradient_probability_map(gt_image)
    flat = rng.choice(H * W, size=num_points, p=prob.reshape(-1))
    if mask is not None:
        flat = flat[~mask.reshape(-1)[flat]]
    if drop_to is not None and len(flat) > drop_to:
        flat = rng.choice(flat, size=drop_to, replace=False)
    ys, xs = np.unravel_index(flat, (H, W))
    xys = np.stack([xs, ys], axis=1).astype(np.float32)
    depths = gt_depth[ys, xs].astype(np.float32)
    scales = 1.0 / prob[ys, xs]
    scales = (scales * 100.0 / scales.sum()).astype(np.float32)
    rgbs = gt_image[ys, xs].astype(np.float32)
    return xys, depths, scales, rgbs
