"""The prior models' floating-point operations for one sequence, counted
from the configuration's widths and the input shapes: the reference's
frozen GMFlow and MASt3R run once each on the meta device (no data, no
time on the card) under ``torch.utils.flop_counter.FlopCounterMode``,
which counts every matrix product, convolution and attention from its
shapes (2 operations a multiply-add). The elementwise work around them is
left out, so the count is a floor of what the models need."""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=8)
def _pair_flops(kind: str, cfg_items: tuple, hw: tuple) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.prep.gmflow import GMFlow, GMFlowConfig
    from reference.prep.vit import Mast3rConfig, Mast3rModel

    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg_items}
    cls, cfg_cls = (GMFlow, GMFlowConfig) if kind == "gmflow" else (Mast3rModel, Mast3rConfig)
    with torch.device("meta"):
        model = cls(cfg_cls(**cfg))
        x = torch.zeros(1, hw[0], hw[1], 3)
        with FlopCounterMode(display=False) as fc:
            model(x, x)
    return float(fc.get_total_flops())


def _items(d: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def pad(n: int, f: int) -> int:
    return n + (-n % f)


def short_side(h: int, w: int, size: int):
    return (size, int(round(w * size / h))) if h <= w else (int(round(h * size / w)), size)


def n_pairs_logwin(n: int, winsize: int) -> int:
    """Directed pairs of the symmetric logwin graph over n frames."""
    return 2 * sum(1 for i in range(n) for k in range(winsize) if i + 2 ** k < n)


def sequence_flops(config: dict, traffic: dict, frames: int) -> dict:
    """{"gmflow", "mast3r", "total"} operations of one sequence: GMFlow both
    ways over the frames - 1 pairs at the padded size, MASt3R over the
    logwin pairs at the inference size."""
    H, W = int(traffic["height"]), int(traffic["width"])
    pf = int(config["padding_factor"])
    g = _pair_flops("gmflow", _items(config["gmflow"]), (pad(H, pf), pad(W, pf)))
    m = _pair_flops("mast3r", _items(config["mast3r"]),
                    short_side(H, W, int(config["inference_size"])))
    gf = 2 * (frames - 1) * g
    mf = n_pairs_logwin(frames, int(config["winsize"])) * m
    return {"gmflow": gf, "mast3r": mf, "total": gf + mf,
            "gmflow_pair": g, "mast3r_pair": m}
