"""File IO for priors and frames (the original GFlow's gflow/utils/read.py
and gflow/utils/conversion.py).

Counterpart of ``gflow_tpu/core/io.py``. All readers return NumPy arrays
(host-side staging data), channels-last. Resizing is antialiased linear,
the shorter side to `size` (torchvision Resize semantics), through
``torch.nn.functional.interpolate(antialias=True)``, which computes the
JAX package's ``jax.image.resize(..., "linear", antialias=True)`` to
float32 rounding.

Image files go through PIL, as the JAX package's do: frames are read with
``Image.open``, masks as ``imageio.v2.imread`` returns them (its PIL
plugin, a palette image expanded to its colors), and images are written
with ``Image.save``, which is what imageio's PNG and JPEG plugin calls.
imageio itself is not needed.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def imread(path) -> np.ndarray:
    """An image file as an array, as imageio.v2.imread returns it."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode == "P":
            img = img.convert(img.palette.mode)
        return np.asarray(img)


def imwrite(path, arr) -> None:
    """An image array to `path`, its format from the suffix."""
    from PIL import Image

    Image.fromarray(np.asarray(arr)).save(path)


def _resize_hw(shape_hw, size: int):
    h, w = shape_hw
    if h <= w:
        return size, int(round(w * size / h))
    return int(round(h * size / w)), size


def resize_image(arr: np.ndarray, size: int | None) -> np.ndarray:
    """Antialiased linear resize of an (H, W, C) or (H, W) float array, the
    shorter side to `size` (torchvision Resize semantics)."""
    if size is None:
        return arr
    return resize_to(arr, _resize_hw(arr.shape[:2], size))


def resize_to(arr: np.ndarray, hw) -> np.ndarray:
    """resize_image's filter to exactly `hw` = (H, W)."""
    if tuple(arr.shape[:2]) == tuple(hw):
        return arr
    squeeze = arr.ndim == 2
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    x = (x[..., None] if squeeze else x).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(x, size=tuple(hw), mode="bilinear",
                                          align_corners=False, antialias=True)
    out = out[0].permute(1, 2, 0).numpy()
    return out[..., 0] if squeeze else out


def gaussian_blur(arr: np.ndarray, kernel_size: int = 7, sigma: float = 5.0):
    """Channel-wise Gaussian blur matching torchvision.GaussianBlur's
    truncated kernel (truncate = half kernel / sigma)."""
    from scipy.ndimage import gaussian_filter

    truncate = ((kernel_size - 1) // 2) / sigma
    if arr.ndim == 2:
        return gaussian_filter(arr, sigma, truncate=truncate, mode="reflect")
    return np.stack([gaussian_filter(arr[..., c], sigma, truncate=truncate, mode="reflect")
                     for c in range(arr.shape[-1])], axis=-1)


def load_image(path, resize: int | None = None, blur: bool = False,
               blur_sigma: float = 5.0, blur_kernel_size: int = 7) -> np.ndarray:
    """Image file -> (H, W, 3) float32 in [0, 1]
    (gflow/utils/conversion.py:6-19)."""
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    img = resize_image(img, resize)
    if blur:
        img = gaussian_blur(img, blur_kernel_size, blur_sigma)
    return np.ascontiguousarray(img, np.float32)


def read_flow(path, resize: int | None = None, blur: bool = False,
              blur_sigma: float = 5.0, blur_kernel_size: int = 7) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (gflow/utils/read.py:7-37).
    As the original, resizing interpolates the field without rescaling
    the vectors."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != 202021.25:
            raise ValueError(f"invalid .flo file: {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    flow = resize_image(data.reshape(h, w, 2), resize)
    if blur:
        flow = gaussian_blur(flow, blur_kernel_size, blur_sigma)
    return np.ascontiguousarray(flow, np.float32)


def write_flow(path, flow: np.ndarray):
    """(H, W, 2) -> Middlebury .flo."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([202021.25], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        np.ascontiguousarray(flow, np.float32).tofile(f)


def read_mask(path, resize: int | None = None) -> np.ndarray:
    """Mask image -> (H, W) bool (gflow/utils/read.py:40-59)."""
    mask = np.asarray(imread(path), np.float32)
    if mask.ndim == 3:
        mask = mask.sum(axis=-1)
    return resize_image(mask, resize) > 0


def read_depth(path, resize: int | None = None, depth_scale: float = 1.0,
               depth_offset: float = 0.0) -> np.ndarray:
    """.npy depth -> (H, W) float32 (gflow/utils/read.py:62-71)."""
    depth = resize_image(np.load(path).astype(np.float32), resize)
    return depth * depth_scale + depth_offset


def read_camera(camera_paths):
    """Per-frame MASt3R camera jsons -> (mean focal, rounded pp, (T, 3, 4)
    world->camera poses) (gflow/utils/read.py:73-89)."""
    focal_list, pose_list, pp = [], [], None
    for p in camera_paths:
        with open(p) as f:
            d = json.load(f)
        focal_list.append(d["focal"])
        pose_list.append(np.asarray(d["pose"], np.float32)[:3])
        pp = [round(d["pp"][0]), round(d["pp"][1])]
    return float(np.mean(focal_list)), pp, np.stack(pose_list)


def write_camera(path, focal: float, pose_w2c_4x4: np.ndarray, pp):
    with open(path, "w") as f:
        json.dump({"focal": float(focal),
                   "pose": np.asarray(pose_w2c_4x4, np.float64).tolist(),
                   "pp": [float(pp[0]), float(pp[1])]}, f)


def list_sequence_files(sequence_path, frame_start=0, frame_range=-1, skip_interval=1):
    """Frames and prior files by the directory-suffix convention of
    gflow/fit_video.py:79-96. As there, frame_range -1 takes all frames
    but the last."""
    seq = Path(sequence_path)
    imgs = sorted(seq.glob("*.png")) + sorted(seq.glob("*.jpg"))
    if frame_range == -1:
        frame_range = len(imgs) - 1

    def window(paths, n=frame_range):
        return paths[frame_start: frame_start + n][::skip_interval]

    sfx = lambda s: Path(str(seq) + s)
    return {
        "images": window(imgs),
        "depths": window(sorted(sfx("_depth_mast3r_s2").glob("*.npy"))),
        "occs": window(sorted(sfx("_flow_unimatch").glob("*occ_bwd.png"))
                       + sorted(sfx("_flow_unimatch").glob("*occ_bwd.jpg")),
                       frame_range - 1),
        "flows": window(sorted(sfx("_flow_unimatch").glob("*pred.flo"))),
        "masks": window(sorted(sfx("_mask").glob("*.png"))),
        "move_masks": window(sorted(sfx("_epipolar").glob("*_open.png"))),
        "cameras": window(sorted(sfx("_camera_mast3r_s2").glob("*.json"))),
    }
