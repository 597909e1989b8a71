"""Depth and camera prior preparation (the reference's
utility/depth_mast3r.py): chunk the sequence (seg_size 200), build the
logwin pair graph, run the two-view model per pair, align globally, and
write per frame:

- <seq>_depth_mast3r_s2/<name>.npy        dense depth (original resolution)
- <seq>_depth_mast3r_s2/<name>.png        colourised depth (turbo)
- <seq>_pts3d_mast3r_s2/<name>.npy        canonical z at inference size
- <seq>_camera_mast3r_s2/<name>.json      {focal, pose (w2c 4x4), pp}

Counterpart of ``gflow_tpu/pipeline/prep_depth.py``. The weights are a
released MASt3R/DUSt3R ``.pth`` or the JAX package's converted ``.npz``
(``--checkpoint`` or ``$GFLOW_MAST3R_WEIGHTS``); without them it raises
``FileNotFoundError``. Inference and the alignment's refinement run on
``cuda`` unless the caller passes ``device="cpu"``, on the card as CUDA
graphs (the model's forward per input shape, ``DEPTH_GRAPHS``; the
alignment's Adam steps, ``models.mast3r.alignment``), as the JAX module
jits them; ``mesh_devices=N`` batches N pairs at a time, one on each of N
devices (``parallel.sharded_batch_apply``, a graph per replica).

As in the JAX module, frames are resized for inference with the short
side to `inference_size` (512: a 854x480 frame runs at 911x512, 1824
tokens a view; 288 gives 512x288, 576 tokens, the size MASt3R's own
loader picks at 512). The depth maps go back to exactly the frame's size,
where the JAX module's short-side resize can miss it by a column (853 for
854 at 288). CLI: ``python -m gflow_tpu_torch.cli.prep_depth``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.io import imwrite, load_image, resize_to, write_camera
from ..models.mast3r import Mast3rModel, convert, global_align, make_pairs_logwin
from ..opt import graphs
from ..viz.colormap import colormap_lookup, print_color
from .prep_flow import batch_runner, list_frames

CKPT_ENV = "GFLOW_MAST3R_WEIGHTS"
# the two-view model's forward graphs (the JAX module's jax.jit(model.apply)):
# one per model, input shapes and device
DEPTH_GRAPHS = graphs.ForwardCache("mast3r", 8)


def load_weights(path=None) -> dict | None:
    """The released-key state dict from `path` or $GFLOW_MAST3R_WEIGHTS
    (a released .pth or a converted .npz); None when there is none."""
    path = path or os.environ.get(CKPT_ENV)
    if not path or not os.path.exists(path):
        return None
    return convert.load_weights(path)


def model_for_params(params: dict) -> Mast3rModel:
    """The model a released-key state dict fits: MASt3R catmlp+dpt (the
    reference's checkpoint) or DUSt3R linear (+ optional desc head), at the
    widths and depths of its keys (convert.config_for_state_dict)."""
    return Mast3rModel(convert.config_for_state_dict(params))


def depth_png(d: np.ndarray) -> np.ndarray:
    """Depth (H, W) -> uint8 RGB through matplotlib's 256-entry turbo
    lookup, min-max normalized."""
    dn = (d - d.min()) / max(d.max() - d.min(), 1e-8)
    return (colormap_lookup(dn, "turbo") * 255).astype(np.uint8)


def main(img_dir: str, checkpoint: Optional[str] = None, inference_size: int = 512,
         seg_size: int = 200, winsize: int = 3, mesh_devices: int = 0,
         device: Optional[str] = None, model=None, params=None):
    """model (a Mast3rModel with its weights) or params (a released-key
    state dict) are injectable, as in the JAX package's tests."""
    if model is None:
        if params is None:
            params = load_weights(checkpoint)
        if params is None:
            raise FileNotFoundError(
                "no MASt3R checkpoint: pass --checkpoint or set "
                f"${CKPT_ENV} to a released .pth or a converted .npz")
        model = model_for_params(params)
    if params is not None:
        model.load_state_dict(params, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    run_batch, B = batch_runner(model, mesh_devices, dev, DEPTH_GRAPHS)

    img_dir = str(img_dir)
    depth_dir = img_dir + "_depth_mast3r_s2"
    pts_dir = img_dir + "_pts3d_mast3r_s2"
    cam_dir = img_dir + "_camera_mast3r_s2"
    for d in (depth_dir, pts_dir, cam_dir):
        os.makedirs(d, exist_ok=True)
    paths = list_frames(img_dir)

    for c0 in range(0, len(paths), seg_size):
        chunk = paths[c0: c0 + seg_size]
        imgs = [torch.from_numpy(load_image(p, resize=inference_size)).to(dev)[None]
                for p in chunk]
        H, W = imgs[0].shape[1:3]
        ratio = load_image(chunk[0]).shape[1] / W  # inference-to-original focal and pp

        edge_preds = {}
        pairs = make_pairs_logwin(len(chunk), winsize)
        with torch.inference_mode():
            for e0 in range(0, len(pairs), B):
                batch = pairs[e0:e0 + B]
                batch += batch[-1:] * (B - len(batch))  # pad the tail batch; dropped below
                o1, o2 = run_batch(torch.cat([imgs[i] for i, _ in batch]),
                                   torch.cat([imgs[j] for _, j in batch]))
                for bi, (i, j) in enumerate(pairs[e0:e0 + B]):
                    # the alignment reads pts3d and conf only
                    edge_preds[(i, j)] = tuple(
                        {k: o[k][bi].cpu().numpy() for k in ("pts3d", "conf")} for o in (o1, o2))
                    print_color(f"[mast3r] pair ({c0 + i},{c0 + j}) done")

        res = global_align(edge_preds, len(chunk), (H, W), device=dev)
        for f, p in enumerate(chunk):
            name = os.path.splitext(os.path.basename(p))[0]
            d = resize_to(res["depths"][f], load_image(p).shape[:2])
            np.save(os.path.join(depth_dir, f"{name}.npy"), d)
            imwrite(os.path.join(depth_dir, f"{name}.png"), depth_png(d))
            np.save(os.path.join(pts_dir, f"{name}.npy"), res["depths"][f])
            write_camera(os.path.join(cam_dir, f"{name}.json"), focal=res["focal"] * ratio,
                         pose_w2c_4x4=np.linalg.inv(res["poses_c2w"][f]),
                         pp=(res["pp"][0] * ratio, res["pp"][1] * ratio))
        print_color(f"[mast3r] chunk {c0}: focal {res['focal']:.1f}, "
                    f"align loss {res['final_loss']:.5f}")
    return depth_dir
