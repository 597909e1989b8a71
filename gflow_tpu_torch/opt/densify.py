"""Error-driven densification into fixed capacity.

Counterpart of ``gflow_tpu/opt/densify.py``. The original GFlow appends
points by torch.cat and rebuilds Adam (gflow/trainer.py:878-951); here the
scene has fixed capacity, so densify writes into the free slots after
n_alive: a static ``max_densify`` sample is drawn and entries beyond the
computed ``densify_num`` are dropped. Sampling is inverse-CDF over the
error-probability map, the distribution of np.random.choice(p=...).

The random draw is split out: ``densify_by_pixels`` takes the
(max_densify,) uniforms in [0, 1) as an argument, so a caller draws them
from its ``torch.Generator`` and a test can hand in JAX's own draw.

Mirrored quirk of the original (gflow/trainer.py:951): after densifying it
rebuilds Adam with ONLY the attribute group at constant lr — its LR
scheduler stays attached to the dead optimizer — so pose/depth updates stop
and the schedule freezes for the rest of the stage. OptState.post_densify
reproduces this (moments reset, pose/depth lr 0, constant attribute lr).
"""
from __future__ import annotations

import torch

from ..core.camera import pix2world
from ..core.scene import activate_inv
from .state import OptState, Params, init_opt_state


@torch.no_grad()
def densify_by_pixels(params: Params, n_alive, error_map, mask, gt_image, gt_depth,
                      intr, extr, num_points, percent, u: torch.Tensor):
    """error_map (H, W) rgb pixel error; mask (H, W) bool region to densify;
    u (max_densify,) uniforms in [0, 1). Returns (new_params, new_n_alive,
    densify_num); n_alive and densify_num are int32 0-d tensors."""
    H, W = error_map.shape
    C = params.capacity
    max_densify = u.shape[0]
    dev = error_map.device
    n_alive = torch.as_tensor(n_alive, dtype=torch.int32, device=dev)

    # error + min-positive uniform floor (trainer.py:884)
    floor = torch.where(error_map > 0, error_map, torch.inf).min()
    floor = torch.where(torch.isfinite(floor), floor, 1e-8)
    err = (error_map + floor) * mask.to(error_map.dtype)

    mask_ratio = mask.to(torch.float32).mean()
    densify_num = (num_points * mask_ratio * percent).to(torch.int32)
    densify_num = torch.minimum(densify_num, torch.tensor(max_densify, dtype=torch.int32, device=dev))
    densify_num = torch.minimum(densify_num, C - n_alive)

    cdf = torch.cumsum(err.reshape(-1), dim=0)
    flat_idx = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(0, H * W - 1)
    ys = torch.div(flat_idx, W, rounding_mode="floor")
    xs = flat_idx % W

    take = torch.arange(max_densify, device=dev) < densify_num
    depths = gt_depth[ys, xs, 0]
    # scales = (1/num_points) * depth/depth.min over the selected sample
    # (trainer.py:912-915)
    dmin = torch.where(take, depths, torch.inf).min()
    dmin = torch.where(torch.isfinite(dmin), dmin, 1.0)
    scales = (1.0 / num_points) * (depths / dmin)
    rgbs = gt_image[ys, xs].clamp(1e-15, 1 - 1e-15)

    uv = torch.stack([xs, ys], dim=1).to(torch.float32)
    new = {
        "xyz": pix2world(uv, depths, intr, extr),
        "scale": scales.abs()[:, None].expand(max_densify, 3),
        "rotate": torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(max_densify, 4),
        "opacity": activate_inv("opacity", torch.full((max_densify, 1), 0.99, device=dev)),
        "rgb": activate_inv("rgb", rgbs),
    }
    # slot n_alive + i for the first densify_num draws; the rest go to a
    # scratch row C that is cut off (no host sync on the draw count)
    slots = torch.where(take, n_alive + torch.arange(max_densify, device=dev), C).long()

    def put(name):
        old = getattr(params, name)
        arr = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
        arr[slots] = new[name]
        return arr[:C]

    new_params = params._replace(**{name: put(name) for name in new})
    return new_params, (n_alive + densify_num).to(torch.int32), densify_num


def reset_opt_after_densify(opt_state: OptState, params: Params) -> OptState:
    return init_opt_state(params)._replace(post_densify=True)
