"""Weight carry-over between the JAX package's state and the port's.

Plain dicts of NumPy arrays keyed by the JAX field names (``xyz, scale,
rotate, opacity, rgb, pose, depth_ab`` for Params; the FrameState and
Targets field names likewise), so the same state can be fed to both
packages and a fit can move from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .opt.state import FrameState, Params, Targets


def _from_numpy(cls, d, device):
    dev = resolve_device(device)
    # np.array copies: the tensors never alias the caller's arrays
    return cls(*(torch.from_numpy(np.array(d[k])).to(dev) for k in cls._fields))


def _to_numpy(x) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in x._asdict().items()}


def params_from_numpy(d: dict, device=None) -> Params:
    return _from_numpy(Params, d, device)


def params_to_numpy(p: Params) -> dict:
    return _to_numpy(p)


def frame_state_from_numpy(d: dict, device=None) -> FrameState:
    return _from_numpy(FrameState, d, device)


def frame_state_to_numpy(s: FrameState) -> dict:
    return _to_numpy(s)


def targets_from_numpy(d: dict, device=None) -> Targets:
    return _from_numpy(Targets, d, device)


def targets_to_numpy(t: Targets) -> dict:
    return _to_numpy(t)
