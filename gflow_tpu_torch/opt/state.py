"""Optimization state: parameters, per-frame state, targets, Adam.

Counterpart of ``gflow_tpu/opt/state.py``. The differentiable parameters
are split from integer/recurrent state. Three lr groups, as the original
GFlow optimizer (gflow/trainer.py:133-148): Gaussian attributes at ``lr``,
camera pose at ``lr_camera``, the depth correction (a, b) at ``lr``. Adam
is written out by hand (torch semantics: b1=.9 b2=.999 eps=1e-8, bias
correction) because the post-densify quirk (opt/densify.py) needs the three
groups explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class Params(NamedTuple):
    """All differentiable leaves. Attribute tensors are raw
    (pre-activation), capacity-padded."""

    xyz: torch.Tensor       # (C, 3)
    scale: torch.Tensor     # (C, 3)
    rotate: torch.Tensor    # (C, 4) wxyz
    opacity: torch.Tensor   # (C, 1)
    rgb: torch.Tensor       # (C, 3)
    pose: torch.Tensor      # (7,) quat xyzw + translation (world->camera)
    depth_ab: torch.Tensor  # (2,) scale/shift-invariant depth correction [a, b]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


# lr-group id per leaf: 0 = attributes, 1 = pose, 2 = depth a/b
PARAM_GROUPS = Params(xyz=0, scale=0, rotate=0, opacity=0, rgb=0, pose=1, depth_ab=2)


class FrameState(NamedTuple):
    """Non-differentiable recurrent state carried across frames."""

    n_alive: torch.Tensor               # () int32
    still_mask: torch.Tensor            # (C,) bool, meaningful for slots < last_num
    still_mask_tentative: torch.Tensor  # (C,) bool — fresh labels incl. old points
    last_uv: torch.Tensor               # (C, 2)
    last_depth: torch.Tensor            # (C, 1)
    last_xyz: torch.Tensor              # (C, 3)
    last_num: torch.Tensor              # () int32 (0 == no previous fit)


def init_frame_state(capacity: int, device=None) -> FrameState:
    """Fresh per-frame state on `device` (``cuda`` unless the caller passes
    another)."""
    C = capacity
    device = resolve_device(device)
    return FrameState(
        n_alive=torch.zeros((), dtype=torch.int32, device=device),
        still_mask=torch.ones(C, dtype=torch.bool, device=device),
        still_mask_tentative=torch.ones(C, dtype=torch.bool, device=device),
        last_uv=torch.zeros((C, 2), device=device),
        last_depth=torch.zeros((C, 1), device=device),
        last_xyz=torch.zeros((C, 3), device=device),
        last_num=torch.zeros((), dtype=torch.int32, device=device),
    )


class Targets(NamedTuple):
    """Per-frame ground-truth priors."""

    image: torch.Tensor      # (H, W, 3) in [0, 1]
    depth: torch.Tensor      # (H, W, 1)
    flow: torch.Tensor       # (H, W, 2) forward flow from the PREVIOUS frame
    move_mask: torch.Tensor  # (H, W) bool epipolar moving-region prior
    occ_mask: torch.Tensor   # (H, W) bool occlusion mask (densify target)


class OptState(NamedTuple):
    """Hand-written Adam state, fresh per stage."""

    m: Params
    v: Params
    step: int
    post_densify: bool  # see opt/densify.py for the mirrored quirk


def init_opt_state(params: Params) -> OptState:
    zeros = Params(*(torch.zeros_like(p) for p in params))
    return OptState(m=zeros, v=zeros, step=0, post_densify=False)


def adam_update(params: Params, grads: Params, opt_state: OptState, lr_attr,
                lr_pose, lr_depth, b1=0.9, b2=0.999, eps=1e-8):
    step = opt_state.step + 1
    # bias corrections in float32, as the reference computes them
    t = torch.full((), step, dtype=torch.float32, device=params.xyz.device)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    lrs = (lr_attr, lr_pose, lr_depth)
    new_m = Params(*(b1 * m + (1 - b1) * g for m, g in zip(opt_state.m, grads)))
    new_v = Params(*(b2 * v + (1 - b2) * g * g for v, g in zip(opt_state.v, grads)))
    new_p = Params(*(
        p - lrs[grp] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        for p, m, v, grp in zip(params, new_m, new_v, PARAM_GROUPS)))
    return new_p, OptState(m=new_m, v=new_v, step=step,
                           post_densify=opt_state.post_densify)
