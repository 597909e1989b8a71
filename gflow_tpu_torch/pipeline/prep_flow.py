"""Optical-flow prior preparation (the reference's
scripts/flow_unimatch.sh): GMFlow over consecutive frame pairs in both
directions, the forward/backward consistency check, and per pair
``<seq>_flow_unimatch/{name}_pred.flo``, ``{name}_pred_bwd.flo`` and
``{name}_occ_bwd.png``.

Counterpart of ``gflow_tpu/pipeline/prep_flow.py``. The weights are a
released UniMatch ``.pth`` or the JAX package's converted ``.npz``
(``--checkpoint`` or ``$GFLOW_UNIMATCH_WEIGHTS``;
``models.unimatch.convert.load_weights``); without them it raises
``FileNotFoundError``. Inference runs on ``cuda`` unless the caller passes
``device="cpu"``, under ``torch.inference_mode()``, in fp32; on the card
each forward replays a CUDA graph recorded once per model and input shape
(``FLOW_GRAPHS``), as the JAX module jits ``model.apply``;
``mesh_devices=N`` batches N directed pairs at a time, one on each of N
devices (``parallel.sharded_batch_apply``, a graph per replica). CLI:
``python -m gflow_tpu_torch.cli.prep_flow``.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.io import imwrite, load_image, write_flow
from ..models.unimatch import GMFlow, convert, forward_backward_consistency
from ..opt import graphs
from ..viz.colormap import print_color

CKPT_ENV = "GFLOW_UNIMATCH_WEIGHTS"
# GMFlow's forward graphs (the JAX module's jax.jit(model.apply)): one per
# model, input shapes and device
FLOW_GRAPHS = graphs.ForwardCache("gmflow", 8)


def load_weights(path=None) -> dict | None:
    """The released-key state dict from `path` or $GFLOW_UNIMATCH_WEIGHTS
    (a released .pth or a converted .npz); None when there is none."""
    path = path or os.environ.get(CKPT_ENV)
    if not path or not os.path.exists(path):
        return None
    return convert.load_weights(path)


def list_frames(img_dir) -> list:
    """A sequence folder's frames: its JPEGs, then its PNGs, each sorted."""
    return sorted(glob.glob(os.path.join(str(img_dir), "*.jpg"))) + sorted(
        glob.glob(os.path.join(str(img_dir), "*.png")))


def main(img_dir: str, checkpoint: Optional[str] = None, resize: Optional[int] = None,
         padding_factor: int = 32, mesh_devices: int = 0, device: Optional[str] = None,
         model=None, params=None):
    """model (a GMFlow with its weights) or params (a released-key state
    dict) are injectable, as in the JAX package's tests."""
    if model is None:
        if params is None:
            params = load_weights(checkpoint)
        if params is None:
            raise FileNotFoundError(
                "no UniMatch checkpoint: pass --checkpoint or set "
                f"${CKPT_ENV} to a released .pth or a converted .npz")
        model = GMFlow(convert.config_for_state_dict(params, padding_factor=padding_factor))
    if params is not None:
        model.load_state_dict(params, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    run_batch, B = batch_runner(model, mesh_devices, dev, FLOW_GRAPHS)

    out_dir = str(img_dir) + "_flow_unimatch"
    os.makedirs(out_dir, exist_ok=True)
    paths = list_frames(img_dir)

    def pad_to(img):
        H, W = img.shape[:2]
        padded = np.pad(img, ((0, -H % padding_factor), (0, -W % padding_factor), (0, 0)))
        return torch.from_numpy(padded).to(dev)[None], (H, W)

    with torch.inference_mode():
        frames = [pad_to(load_image(p, resize=resize)) for p in paths]
        # directed jobs (pair, direction): fwd and bwd of a pair are
        # independent inferences, batched B at a time across the mesh
        jobs = [(i, d) for i in range(len(paths) - 1) for d in (0, 1)]
        flows = {}
        for c0 in range(0, len(jobs), B):
            chunk = jobs[c0:c0 + B]
            chunk += chunk[-1:] * (B - len(chunk))  # pad the tail batch; dropped below
            a = torch.cat([frames[i + d][0] for i, d in chunk])
            b = torch.cat([frames[i + 1 - d][0] for i, d in chunk])
            out = run_batch(a, b)
            for k, job in enumerate(jobs[c0:c0 + B]):
                H, W = frames[job[0]][1]
                flows[job] = out[k:k + 1, :H, :W]
        for i in range(len(paths) - 1):
            fwd, bwd = flows[(i, 0)], flows[(i, 1)]
            _, occ_b = forward_backward_consistency(fwd, bwd)
            fwd, bwd = fwd[0].cpu().numpy(), bwd[0].cpu().numpy()
            name = os.path.splitext(os.path.basename(paths[i]))[0]
            write_flow(os.path.join(out_dir, f"{name}_pred.flo"), fwd)
            write_flow(os.path.join(out_dir, f"{name}_pred_bwd.flo"), bwd)
            imwrite(os.path.join(out_dir, f"{name}_occ_bwd.png"),
                    (occ_b[0].cpu().numpy() * 255).astype(np.uint8))
            print_color(f"[flow] {name}: |flow| mean {np.abs(fwd).mean():.2f}")
    return out_dir


def batch_runner(model, mesh_devices: int, device, cache: graphs.ForwardCache):
    """(run, B): the model's forward through `cache` (on the card a CUDA
    graph per model and input shapes, ``opt.graphs.module_call``) with
    batch 1, or with mesh_devices > 0 a sharded_batch_apply of it over a
    ("data",) mesh of that many devices of device's kind
    (parallel.make_mesh: cards must be visible), one graph per replica,
    batch mesh_devices."""
    if not mesh_devices:
        return (lambda *x: graphs.module_call(cache, model, *x)), 1
    from ..parallel.mesh import make_mesh, sharded_batch_apply

    mesh = make_mesh(mesh_devices, data_parallel=mesh_devices, device=device.type)
    return sharded_batch_apply(model, mesh, cache), mesh.shape["data"]
