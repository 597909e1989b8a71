"""The prior preparation done plainly, in memory, on the frames the
benchmark wrote and the weights it made: GMFlow both ways with the
forward-backward check (the port's ``pipeline/prep_flow.py``), the masks an
epipolar error map allows (``prep_moveseg.py``'s threshold and
morphology), MASt3R over the logwin pair graph and the global alignment
(``prep_depth.py``), every model eager and in float32 (or, for the
control, with TF32)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import precision
from .alignment import global_align, make_pairs_logwin
from .gmflow import GMFlow, GMFlowConfig, forward_backward_consistency
from .vit import Mast3rConfig, Mast3rModel


@contextlib.contextmanager
def mode(m: str):
    prev = precision.MODE
    precision.MODE = m
    try:
        yield
    finally:
        precision.MODE = prev


def load_image(path) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    return np.ascontiguousarray(img[..., :3])


def resize_to(arr: np.ndarray, hw) -> np.ndarray:
    """Antialiased bilinear resize to exactly hw (the port's ``resize_to``)."""
    if tuple(arr.shape[:2]) == tuple(hw):
        return arr
    squeeze = arr.ndim == 2
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    x = (x[..., None] if squeeze else x).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(x, size=tuple(hw), mode="bilinear",
                                          align_corners=False, antialias=True)
    out = out[0].permute(1, 2, 0).numpy()
    return out[..., 0] if squeeze else out


def short_side(hw, size: int):
    h, w = hw
    return (size, int(round(w * size / h))) if h <= w else (int(round(h * size / w)), size)


def meta_model(cls, cfg, state_dict, device):
    with torch.device("meta"):
        model = cls(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device).eval()


def gmflow(cfg: dict, state_dict, device) -> GMFlow:
    return meta_model(GMFlow, GMFlowConfig(**cfg), state_dict, device)


def mast3r(cfg: dict, state_dict, device) -> Mast3rModel:
    return meta_model(Mast3rModel, Mast3rConfig(**cfg), state_dict, device)


@torch.no_grad()
def flows(model, paths, pairs, padding_factor: int, device):
    """{i: (fwd (H, W, 2), bwd, occ_bwd (H, W) 0/1)} of the pairs (i, i+1)."""
    def padded(p):
        img = load_image(p)
        H, W = img.shape[:2]
        img = np.pad(img, ((0, -H % padding_factor), (0, -W % padding_factor), (0, 0)))
        return torch.from_numpy(img).to(device)[None], (H, W)

    out = {}
    for i in pairs:
        (a, (H, W)), (b, _) = padded(paths[i]), padded(paths[i + 1])
        fwd = model(a, b)[:, :H, :W]
        bwd = model(b, a)[:, :H, :W]
        _, occ_b = forward_backward_consistency(fwd, bwd)
        out[i] = (fwd[0].cpu().numpy(), bwd[0].cpu().numpy(), occ_b[0].cpu().numpy())
    return out


def _disk(radius: int) -> np.ndarray:
    yy, xx = np.ogrid[-radius: radius + 1, -radius: radius + 1]
    return (xx * xx + yy * yy) <= radius * radius


def masks_between(error_png: np.ndarray, threshold: float):
    """The masks that an error map written as uint8(err * 255) allows:
    (low, high), each {"open", "erode", "dilate"}. A value v stands for an
    err in [v / 255, (v + 1) / 255), so err > threshold holds for certain
    when v / 255 > threshold and may hold when (v + 1) / 255 > threshold;
    the morphology is monotone, so every mask the map allows lies between
    the two."""
    from scipy.ndimage import binary_dilation, binary_erosion, binary_opening

    v = error_png.astype(np.float64)
    out = []
    for base in (v / 255 > threshold, (v + 1) / 255 > threshold):
        out.append({"open": binary_opening(base, structure=_disk(2)),
                    "erode": binary_erosion(base, structure=_disk(5)),
                    "dilate": binary_dilation(base, structure=_disk(3))})
    return tuple(out)


@torch.no_grad()
def depth_and_cameras(model, paths, inference_size: int, winsize: int, device) -> dict:
    """{"depth": [(H, W)] at the frames' size, "focal", "pose_w2c": [4x4],
    "pp"} of one chunk of frames."""
    full = load_image(paths[0]).shape[:2]
    hw = short_side(full, inference_size)
    imgs = [torch.from_numpy(resize_to(load_image(p), hw)).to(device)[None] for p in paths]
    H, W = imgs[0].shape[1:3]
    ratio = full[1] / W
    edge = {}
    for i, j in make_pairs_logwin(len(paths), winsize):
        o1, o2 = model(imgs[i], imgs[j])
        edge[(i, j)] = tuple({k: o[k][0].cpu().numpy() for k in ("pts3d", "conf")}
                             for o in (o1, o2))
    res = global_align(edge, len(paths), (H, W), device=device)
    return {"depth": [resize_to(d, full) for d in res["depths"]],
            "focal": res["focal"] * ratio,
            "pose_w2c": [np.linalg.inv(p) for p in res["poses_c2w"]],
            "pp": (res["pp"][0] * ratio, res["pp"][1] * ratio)}
