"""The operations of SAM 2's work on one sequence of the video mask prior,
counted from the configuration's widths and the frames' shapes, never
from how a kernel does it.

The reference's parts (``reference/sam2/model.py``) run on the meta device
(no data, no time on the card) under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matrix
product, convolution and attention from its shapes (2 operations a
multiply-add); the elementwise work around them is left out, so each count
is a floor of what the model needs:

- ``encode_flops``: a frame's encoder (Hiera, the neck, conv_s0 / conv_s1);
- ``memattn_flops``: the memory attention of every tracked frame of a
  sequence, each at its bank's fill (frame f attends 1 + min(f - 1, 6)
  memories and 1 + min(f - 1, 15) pointers), all objects;
- ``memattn_steady_flops``: one frame's with the bank full.
"""
from __future__ import annotations

import functools


def _items(d: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


@functools.lru_cache(maxsize=4)
def _encode_flops(cfg_items: tuple, hw: tuple) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.sam2 import model as ref
    from reference.sam2.shapes import state_shapes

    cfg = dict(cfg_items)
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in state_shapes(cfg).items()}
        with FlopCounterMode(display=False) as fc:
            ref.encode(cfg, sd, torch.zeros(hw[0], hw[1], 3))
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=64)
def _memattn_flops(cfg_items: tuple, objects: int, memories: int, pointers: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.sam2 import model as ref
    from reference.sam2.shapes import state_shapes

    cfg = dict(cfg_items)
    C, M = cfg["d_model"], cfg["mem_dim"]
    g = cfg["image_size"] // (4 * cfg["q_stride"] ** 2)
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in state_shapes(cfg).items()}
        memory = torch.empty(memories * g * g + pointers * (C // M), objects, M)
        with FlopCounterMode(display=False) as fc:
            ref.condition(cfg, sd, torch.empty(1, C, g, g), torch.empty(1, C, g, g), memory,
                          torch.empty_like(memory), pointers * (C // M))
    return float(fc.get_total_flops())


def sequence_work(config: dict, traffic: dict) -> dict:
    """A sequence's {"encode_flops" (a frame), "memattn_flops" (the
    sequence), "memattn_steady_flops" (a frame with the bank full),
    "frames", "objects"}."""
    cfg = config["sam2"]
    items = _items(cfg)
    frames, objects = int(config["sequence_frames"]), int(traffic["objects"])
    K = min(frames, cfg["max_obj_ptrs_in_encoder"])
    fill = lambda f: (1 + min(f - 1, cfg["num_maskmem"] - 1), 1 + min(f - 1, K - 1))
    mem = sum(_memattn_flops(items, objects, *fill(f)) for f in range(1, frames))
    return {"encode_flops": _encode_flops(items, (int(traffic["height"]), int(traffic["width"]))),
            "memattn_flops": mem,
            "memattn_steady_flops": _memattn_flops(items, objects, cfg["num_maskmem"], K),
            "frames": frames, "objects": objects}
