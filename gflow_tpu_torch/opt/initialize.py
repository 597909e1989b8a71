"""Parameter initialization from the first frame
(SimpleGaussian.init_gaussians_from_image, gflow/trainer.py:206-238).

Counterpart of ``gflow_tpu/opt/initialize.py``: sampling runs on the host
with a NumPy ``rng``, so a shared seed gives the same points as the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import extr_to_pose, pix2world
from ..core.sampling import complex_texture_sampling
from ..core.scene import activate_inv
from .state import Params


def init_params_from_image(gt_image: np.ndarray, gt_depth: np.ndarray,
                           num_points: int, capacity: int, intr, extr,
                           mask: np.ndarray | None = None,
                           drop_to: int | None = None,
                           rng: np.random.Generator | None = None,
                           device=None):
    """Returns (Params on `device`, n_alive int). Gradient-importance pixel
    sampling, unprojection through the current camera, scales proportional
    to depth clamped at 1e-3, opacity 0.99, random rotations."""
    dev = resolve_device(device)
    xys, depths, scales, rgbs = complex_texture_sampling(
        gt_image, gt_depth, num_points=num_points, mask=mask, drop_to=drop_to,
        rng=rng)
    n = xys.shape[0]
    if n > capacity:
        raise ValueError(f"init produced {n} > capacity {capacity} points")
    if rng is None:
        rng = np.random.default_rng()

    intr = torch.as_tensor(np.asarray(intr, np.float32))
    extr = torch.as_tensor(np.asarray(extr, np.float32))
    xyz = pix2world(torch.from_numpy(xys), torch.from_numpy(depths), intr, extr).numpy()
    scales = scales * (depths / depths.min())
    scales = np.clip(scales, None, 1e-3)
    scales3 = np.repeat(scales[:, None], 3, axis=1)
    rgbs = np.clip(rgbs, 1e-15, 1 - 1e-15)
    rot = rng.random((n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    params = Params(
        xyz=pad(xyz),
        scale=pad(np.abs(scales3), 1e-8),
        rotate=pad(rot, 0.5),
        opacity=pad(activate_inv("opacity", torch.full((n, 1), 0.99)).numpy(), -1.0),
        rgb=pad(activate_inv("rgb", torch.from_numpy(rgbs)).numpy()),
        pose=extr_to_pose(extr).to(dev),
        depth_ab=torch.tensor([1.0, 0.0], device=dev),
    )
    return params, n
