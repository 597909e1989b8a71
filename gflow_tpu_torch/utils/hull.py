"""Concave-hull segmentation of point clouds (the original GFlow's
gflow/utils/concave_hull.py: cubao concave_hull + shapely + PIL).

Counterpart of ``gflow_tpu/utils/hull.py``. It uses the repository's
native C++ library (``native/concave_hull.cpp``, a sibling of both
packages, plain C ABI through ctypes, built with ``make`` on first use if
the library is missing) and falls back to scipy's convex hull when the
library is unavailable or the concave algorithm does not close. Without
the library, polygons are filled by a NumPy copy of its even-odd
scanline rule. Boundary smoothing mirrors the original (linear resample
x factor, then wrap-mode gaussian_filter1d, sigma 2).
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter1d

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"


@functools.lru_cache(maxsize=None)
def _load_native():
    so = NATIVE_DIR / "libgflow_native.so"
    try:
        if not so.exists():
            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(so))
        lib.concave_hull.restype = ctypes.c_int
        lib.concave_hull.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.rasterize_polygon.restype = None
        lib.rasterize_polygon.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_ubyte)]
    except (OSError, AttributeError, subprocess.SubprocessError):
        return None
    return lib


def native_loaded() -> bool:
    """Whether the native hull library loaded (building it if need be)."""
    return _load_native() is not None


def concave_hull_points(points: np.ndarray, k: int = 16) -> np.ndarray:
    """(N, 2) points -> (M, 2) ordered hull boundary points."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    lib = _load_native()
    if lib is not None and n >= 3:
        out = np.empty(n, np.int32)
        m = lib.concave_hull(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n)
        if m > 2:
            return pts[out[:m]]
    from scipy.spatial import ConvexHull, QhullError

    try:
        return pts[ConvexHull(pts).vertices]
    except (QhullError, ValueError):
        return pts


def gaussian_smooth_closed(coords: np.ndarray, sigma: float = 2.0,
                           num_points_factor: int = 5) -> np.ndarray:
    """Resample + wrap-mode gaussian smooth of a closed boundary
    (gflow/utils/concave_hull.py:18-33)."""
    coords = np.asarray(coords, np.float64)
    n = coords.shape[0]
    if n < 3 or sigma <= 0:
        return coords
    xp = np.linspace(0, 1, n)
    xq = np.linspace(0, 1, n * num_points_factor)
    x = gaussian_filter1d(np.interp(xq, xp, coords[:, 0]), sigma, mode="wrap")
    y = gaussian_filter1d(np.interp(xq, xp, coords[:, 1]), sigma, mode="wrap")
    return np.stack([x, y], axis=1)


def polygon_to_mask(poly: np.ndarray, width: int, height: int) -> np.ndarray:
    """Closed polygon -> (H, W) uint8 {0, 1} mask."""
    poly = np.ascontiguousarray(poly, np.float32)
    lib = _load_native()
    if lib is not None and len(poly) >= 3:
        mask = np.zeros((height, width), np.uint8)
        lib.rasterize_polygon(poly.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(poly),
                              width, height,
                              mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        return mask
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in poly], outline=1, fill=1)
    return np.asarray(img, np.uint8)


class FastConcaveHull2D:
    """API of the original's wrapper (gflow/utils/concave_hull.py:73-92)."""

    def __init__(self, points, sigma: float = 2.0, num_points_factor: int = 5):
        self.points = np.asarray(points, np.float32)
        hull = concave_hull_points(self.points)
        if sigma > 0:
            hull = gaussian_smooth_closed(hull, sigma, num_points_factor)
        self.hull = hull

    def area(self) -> float:
        x, y = self.hull[:, 0], self.hull[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))

    def mask(self, width: int, height: int) -> np.ndarray:
        return polygon_to_mask(self.hull, width, height)
