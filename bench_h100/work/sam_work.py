"""The operations and bytes of SAM's work on one frame of the mask prior,
counted from the configuration's widths and the frame's shapes, never from
how a kernel does it.

- Operations: the reference's encoder and one batch's decode
  (``reference/sam/model.py``) run on the meta device (no data, no time on
  the card) under ``torch.utils.flop_counter.FlopCounterMode``, which
  counts every matrix product, convolution and einsum from its shapes (2
  operations a multiply-add). The elementwise work around them is left
  out, so the count is a floor of what the models need.
- Bytes: what a batch's decode and post-processing must read and write,
  each once: the decode reads the image embedding and the decoder's
  weights and writes the low-resolution logits and IoUs; the
  post-processing reads those logits and writes one bool a pixel of each
  mask at the frame's size and a count pair a mask.
"""
from __future__ import annotations

import functools
import math


@functools.lru_cache(maxsize=8)
def _flops(cfg_items: tuple, hw: tuple, batch: int) -> tuple:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.sam import model as ref
    from reference.sam.shapes import state_shapes

    cfg = dict(cfg_items)
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in state_shapes(cfg).items()}
        frame = torch.zeros(hw[0], hw[1], 3)
        with FlopCounterMode(display=False) as fc:
            emb = ref.embed(cfg, sd, frame)
        enc = float(fc.get_total_flops())
        with FlopCounterMode(display=False) as fc:
            ref.decode(cfg, sd, emb, torch.zeros(batch, 1, 2, dtype=torch.float64))
        dec = float(fc.get_total_flops())
    return enc, dec


def _items(d: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def decoder_params(cfg: dict) -> int:
    """Parameters under ``prompt_encoder.`` and ``mask_decoder.``."""
    from reference.sam.shapes import state_shapes

    return sum(math.prod(s) for k, s in state_shapes(cfg).items()
               if not k.startswith("image_encoder."))


def frame_work(config: dict, traffic: dict) -> dict:
    """One frame's {"encode_flops", "decode_flops", "decode_bytes",
    "post_bytes"} (decode and post over all of the grid's batches, the
    tail batch padded as the program pads it)."""
    cfg, g = config["sam"], config["generator"]
    H, W = int(traffic["height"]), int(traffic["width"])
    B = int(g["points_per_batch"])
    batches = -(-int(g["points_per_side"]) ** 2 // B)
    enc, dec = _flops(_items(cfg), (H, W), B)
    grid = cfg["image_size"] // cfg["patch_size"]
    masks = B * cfg["num_multimask_outputs"]
    low = masks * (4 * grid) ** 2 * 4
    decode_bytes = (cfg["prompt_embed_dim"] * grid * grid * 4 + decoder_params(cfg) * 4
                    + B * 2 * 8 + low + masks * 4)
    post_bytes = low + masks * 4 + masks * H * W + masks * 2 * 8
    return {"encode_flops": enc, "decode_flops": batches * dec,
            "decode_bytes": batches * decode_bytes, "post_bytes": batches * post_bytes,
            "batches": batches}
