"""Gaussian attribute activations and the fixed-capacity convention.

Counterpart of ``gflow_tpu/core/scene.py``. Attributes are kept raw
(pre-activation) in capacity-padded tensors; slots [0, n_alive) are live.

    scale   = |x|                 (inverse is also |x|)
    rotate  = x / ||x||           (wxyz quaternion)
    opacity = sigmoid(10 * x)     ("sensitive sigmoid")
    rgb     = sigmoid(x)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

OPACITY_SENSITIVITY = 10.0


class GaussianScene(NamedTuple):
    """Raw (pre-activation) Gaussian attributes with a fixed capacity C."""

    xyz: torch.Tensor      # (C, 3)
    scale: torch.Tensor    # (C, 3) raw; activated by abs
    rotate: torch.Tensor   # (C, 4) wxyz; activated by L2-normalize
    opacity: torch.Tensor  # (C, 1) raw; activated by sigmoid(10x)
    rgb: torch.Tensor      # (C, 3) raw; activated by sigmoid
    n_alive: int           # number of live prefix slots

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def activated(self):
        """(xyz, scale, rotate, opacity, rgb) with activations applied and
        dead slots forced transparent."""
        alive = (torch.arange(self.capacity, device=self.xyz.device) < self.n_alive)[:, None]
        return (self.xyz, torch.abs(self.scale), _normalize(self.rotate),
                torch.sigmoid(self.opacity * OPACITY_SENSITIVITY) * alive,
                torch.sigmoid(self.rgb))


def _normalize(q, eps=1e-12):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def activate(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "scale":
        return torch.abs(x)
    if name == "rotate":
        return _normalize(x)
    if name == "opacity":
        return torch.sigmoid(x * OPACITY_SENSITIVITY)
    if name == "rgb":
        return torch.sigmoid(x)
    return x


def activate_inv(name: str, x: torch.Tensor) -> torch.Tensor:
    """Inverse activations used when writing values into the raw state."""
    if name == "scale":
        return torch.abs(x)
    if name == "rotate":
        return _normalize(x)
    if name == "opacity":
        return torch.logit(x.clamp(1e-15, 1 - 1e-15)) / OPACITY_SENSITIVITY
    if name == "rgb":
        return torch.logit(x.clamp(1e-15, 1 - 1e-15))
    return x


def scene_capacity(n_points: int, headroom: float = 2.0, align: int = 1024) -> int:
    """A static capacity: n_points * headroom rounded up to `align`."""
    c = int(n_points * headroom)
    return max(align, -(-c // align) * align)

