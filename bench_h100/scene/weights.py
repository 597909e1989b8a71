"""Seeded random weights in a released checkpoint's key layout, made on the
device in one draw: each tensor uniform in +-scale / sqrt(fan_in) of its
weight (torch's default Linear / Conv2d spread), LayerNorm weights (1-D
``.weight``) `scale` and their biases 0, as the port's
``models/random_weights.py`` spreads them on the host. The keys and shapes
are the model's own (a model built on the meta device), which load the
released checkpoints strictly."""
from __future__ import annotations

import math

import torch


def shapes_of(model: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def seeded_state_dict(shapes: dict, seed: int, scale: float, device) -> dict:
    """{key: float32 tensor on `device`}, views into one buffer drawn by one
    ``torch.rand`` call of a generator seeded with `seed`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device)
    sd, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        w = shapes.get(k[:-4] + "weight", shape) if k.endswith(".bias") else shape
        if len(w) == 1:
            v.fill_(scale if k.endswith(".weight") else 0.0)
        else:
            bound = scale / math.sqrt(math.prod(w[1:]))
            v.mul_(2 * bound).sub_(bound)
        sd[k] = v
    return sd
