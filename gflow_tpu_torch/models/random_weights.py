"""Seeded random weights in a released checkpoint's key layout.

No released UniMatch or MASt3R weights are in the repository, so the prior
models run on random weights until they are: ``seeded_state_dict`` makes
them from a seed with NumPy, from a key -> shape manifest
(``convert.expected_torch_keys``), with the spread of torch's default
initialization times `scale` (the models' exp / expm1 outputs overflow on
unscaled random weights).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def seeded_state_dict(shapes: dict, seed: int = 0, scale: float = 1.0) -> dict:
    """{key: shape} -> {key: float32 CPU tensor}. Weights and biases are
    uniform in +-scale / sqrt(fan_in) of their weight (torch's default
    Linear / Conv2d spread); LayerNorm weights (1-D ``.weight``) are
    `scale` and their biases 0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        w = shapes.get(k[:-4] + "weight", shape) if k.endswith(".bias") else shape
        if len(w) == 1:
            v = np.full(shape, scale if k.endswith(".weight") else 0.0, np.float32)
        else:
            bound = scale / math.sqrt(int(np.prod(w[1:])))
            v = (rng.random(shape, dtype=np.float32) * 2 - 1) * np.float32(bound)
        sd[k] = torch.from_numpy(v)
    return sd
