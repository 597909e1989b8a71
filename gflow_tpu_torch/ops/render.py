"""High-level multi-output render.

Counterpart of ``gflow_tpu/ops/render.py``: rgb, uv, depth, depth_map,
depth_map_color, acc and center. All feature maps that share the standard
conic/opacity are composited in ONE pass over concatenated feature
channels; the "center" view (identity conic, opacity 1) reuses the same
tile lists; ``render_traj`` draws a trajectory line set with a scaled
identity conic. Images are channels-last (H, W, C). The device of the
inputs picks the compositor: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors. A config with ``band_devices`` (set by
``for_scene`` inside ``parallel.mesh.use_mesh``) composites through the
band wrappers, one band of tile rows per device. Host callers (the
trainer) call these under ``torch.no_grad()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import ambient_tile_devices
from ..viz.colormap import apply_float_colormap
from . import cuda_raster
from .binning import bin_gaussians, tile_grid
from .projection import project_gaussians, supported_max_radius


@dataclass(frozen=True)
class RenderConfig:
    # depth-sorted truncation keeps the NEAREST K per tile
    max_per_tile: int = 128
    max_tiles_per_gaussian: int = 16
    # two-class binning (ops/binning.bin_gaussians): >0 = splats whose
    # tile-rect fits this smaller grid emit it; at most large_frac*N splats
    # get the full grid (largest area first). 0 = single-class.
    small_tiles_per_gaussian: int = 0
    large_frac: float = 0.125
    # the tile-band mode: one band of tile rows per device (None: unbanded)
    band_devices: tuple | None = None

    @classmethod
    def for_scene(cls, W: int, H: int, num_points: int, image=None) -> "RenderConfig":
        """Scene-adaptive caps (the JAX trainer's default): the smallest
        max_tiles_per_gaussian whose supported radius covers ~2.5x the
        typical pixel's distance to its nearest splat, 1/sqrt(N *
        median(p)) under the gradient-importance init distribution p (the
        uniform sqrt(W*H/N) without an image). M=8 takes K=96, wider grids
        K=128 with two-class emission. Calibration: gflow_tpu/ops/render.py
        and M_QUALITY.json / K_QUALITY.json. Inside ``use_mesh`` the config
        bands over the mesh's devices (ambient_tile_devices)."""
        spacing = math.sqrt(W * H / max(num_points, 1))
        if image is not None:
            from ..core.sampling import gradient_probability_map

            p_med = float(np.median(gradient_probability_map(
                np.asarray(image, np.float32))))
            spacing = 1.0 / math.sqrt(max(num_points * p_med, 1e-12))
        need = 2.5 * spacing
        bands = ambient_tile_devices()
        for m in (8, 12, 16, 48):
            if supported_max_radius(m) >= need:
                return cls(max_per_tile=96 if m == 8 else 128,
                           max_tiles_per_gaussian=m,
                           small_tiles_per_gaussian=0 if m == 8 else 8,
                           band_devices=bands)
        return cls(max_per_tile=128, max_tiles_per_gaussian=64,
                   small_tiles_per_gaussian=8, band_devices=bands)


DEFAULT_CONFIG = RenderConfig()


def bin_with(config: RenderConfig, uv, depth, radius, W: int, H: int):
    return bin_gaussians(
        uv, depth, radius, W, H,
        max_per_tile=config.max_per_tile,
        max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        small_tiles_per_gaussian=config.small_tiles_per_gaussian,
        large_frac=config.large_frac,
    )


def composite(config: RenderConfig, tile_lists, uv, conic, opacity, features, bg, W: int,
              H: int, n_tx: int, n_ty: int, tile_counts=None):
    """The tile compositor `config` asks for: banded over its band_devices,
    or in one piece (the JAX package's ``_get_compositor``)."""
    if config.band_devices:
        return cuda_raster.composite_tiles_kernel_sharded(
            tile_lists, uv, conic, opacity, features, bg, W, H, n_tx, n_ty,
            config.band_devices, tile_counts=tile_counts)
    return cuda_raster.composite_tiles_kernel(tile_lists, uv, conic, opacity, features, bg,
                                              W, H, n_tx, n_ty, tile_counts=tile_counts)


def composite_with_coverage(config: RenderConfig, tile_lists, uv, conic, opacity, features,
                            mov, bg, W: int, H: int, n_tx: int, n_ty: int, tile_counts=None):
    """The coverage compositor `config` asks for, banded or in one piece."""
    if config.band_devices:
        return cuda_raster.composite_with_coverage_kernel_sharded(
            tile_lists, uv, conic, opacity, features, mov, bg, W, H, n_tx, n_ty,
            config.band_devices, tile_counts=tile_counts)
    return cuda_raster.composite_with_coverage_kernel(
        tile_lists, uv, conic, opacity, features, mov, bg, W, H, n_tx, n_ty,
        tile_counts=tile_counts)


def render(xyz, scale, rotate, opacity, rgb, intr, extr, bg, W: int, H: int,
           outputs: Sequence[str] = ("rgb", "uv", "depth", "depth_map",
                                     "depth_map_color", "center"),
           config: RenderConfig = DEFAULT_CONFIG, as_uint8: bool = False,
           device=None):
    """All array inputs are *activated* values; they are moved to `device`
    (``cuda`` unless the caller passes another). Returns a dict of the
    requested outputs: rgb/depth_map/depth_map_color/acc/center are
    (H, W, C); uv is (N, 2); depth is (N, 1) with 0 == culled. as_uint8
    quantizes the image-type outputs (rgb/depth_map_color/center/acc)."""
    dev = resolve_device(device)
    xyz, scale, rotate, opacity, rgb, intr, extr = (
        torch.as_tensor(x, dtype=torch.float32).to(dev)
        for x in (xyz, scale, rotate, opacity, rgb, intr, extr))
    proj = project_gaussians(
        xyz, scale, rotate, intr, extr, W, H,
        max_radius=supported_max_radius(config.max_tiles_per_gaussian))
    uv, depth, conic, radius = proj["uv"], proj["depth"], proj["conic"], proj["radius"]

    out = {}
    if "uv" in outputs:
        out["uv"] = uv
    if "depth" in outputs:
        out["depth"] = depth
    # as the reference: acc rides along with rgb/depth outputs, never alone
    need_main = any(k in outputs for k in ("rgb", "depth_map", "depth_map_color"))
    need_center = "center" in outputs
    if not (need_main or need_center):
        return out

    n_tx, n_ty = tile_grid(W, H)
    bins = bin_with(config, uv, depth, radius, W, H)

    if need_main:
        feats, slices = [], {}

        def add(name, f):
            start = sum(x.shape[1] for x in feats)
            feats.append(f)
            slices[name] = (start, start + f.shape[1])

        if "rgb" in outputs:
            add("rgb", rgb)
        if "depth_map" in outputs:
            add("depth_map", depth)
        if "depth_map_color" in outputs:
            add("depth_map_color",
                apply_float_colormap(depth, colormap="turbo", non_zero=True))
        if "acc" in outputs:
            # a ones channel composites to sum(alpha_i * T_i)
            add("acc", torch.ones_like(depth))
        cursor = sum(x.shape[1] for x in feats)
        # the acc channel gets bg 0 so it reads sum(alpha_i * T_i) directly
        bg_vec = torch.full((cursor,), float(bg), dtype=torch.float32, device=dev)
        if "acc" in slices:
            bg_vec[slices["acc"][0]] = 0.0
        img = composite(config, bins.tile_lists, uv, conic, opacity, torch.cat(feats, dim=1),
                        bg_vec, W, H, n_tx, n_ty, tile_counts=bins.tile_counts)
        for name, (s, e) in slices.items():
            out[name] = img[..., s:e]
        if "acc" in out:
            out["acc"] = out["acc"].clamp(0.0, 1.0)

    if need_center:
        # identity conic + opacity 1 point-cloud view; opacity-masked points
        # (dead capacity slots) stay invisible
        center_conic = torch.tensor([1.0, 0.0, 1.0], device=dev).expand_as(conic)
        center_op = ((depth > 0) & (opacity > 0)).to(torch.float32)
        out["center"] = composite(config, bins.tile_lists, uv, center_conic, center_op, rgb,
                                  bg, W, H, n_tx, n_ty, tile_counts=bins.tile_counts)

    if as_uint8:
        for name in ("rgb", "depth_map_color", "center", "acc"):
            if name in out:
                out[name] = (out[name].clamp(0.0, 1.0) * 255).to(torch.uint8)
    return out


def render_scene(scene, camera, bg, W: int, H: int, outputs,
                 config: RenderConfig = DEFAULT_CONFIG, device=None):
    """Render a core.scene.GaussianScene through a core.camera.Camera
    (activations applied here)."""
    xyz, scale, rotate, opacity, rgb = scene.activated()
    return render(xyz, scale, rotate, opacity, rgb, camera.intr, camera.extr, bg, W, H,
                  outputs, config, device=device)


def render_traj(xyz, scale, rotate, opacity, rgb, intr, extr, bg, W: int, H: int,
                point_num: int, line_scale: float = 1.0, point_scale: float = 2.0,
                config: RenderConfig = DEFAULT_CONFIG, n_actual: int | None = None,
                device=None):
    """Trajectory line-set render: the conic is a scaled identity, point_scale
    for the first n - point_num entries and line_scale for the rest (the
    original GFlow's gflow/utils/render.py:110-156 scales the first
    len - point_num entries by point_scale; mirrored exactly). n_actual is
    the logical count when the arrays are padded to a fixed capacity
    (padding slots carry opacity 0). Returns the (H, W, 3) image."""
    dev = resolve_device(device)
    xyz, scale, rotate, opacity, rgb, intr, extr = (
        torch.as_tensor(x, dtype=torch.float32).to(dev)
        for x in (xyz, scale, rotate, opacity, rgb, intr, extr))
    proj = project_gaussians(xyz, scale, rotate, intr, extr, W, H)
    n_tx, n_ty = tile_grid(W, H)
    bins = bin_with(config, proj["uv"], proj["depth"], proj["radius"], W, H)
    n = xyz.shape[0]
    cutoff = (n if n_actual is None else int(n_actual)) - point_num
    scale_per_pt = torch.where(torch.arange(n, device=dev) < cutoff, point_scale,
                               line_scale)[:, None]
    conic = torch.tensor([1.0, 0.0, 1.0], device=dev) * scale_per_pt
    return composite(config, bins.tile_lists, proj["uv"], conic, opacity, rgb, bg, W, H, n_tx,
                     n_ty, tile_counts=bins.tile_counts)


def render2img(rendered: torch.Tensor) -> np.ndarray:
    """(H, W, C) float -> uint8 numpy image, quantized on the device before
    the host transfer."""
    if rendered.dtype != torch.uint8:
        rendered = (rendered.detach().clamp(0.0, 1.0) * 255).to(torch.uint8)
    return rendered.cpu().numpy()
