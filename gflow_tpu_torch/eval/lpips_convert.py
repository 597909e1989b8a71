"""LPIPS(AlexNet) torch-checkpoint -> .npz converter.

Counterpart of ``gflow_tpu/eval/lpips_convert.py`` (copied; it writes the
same .npz, so one file serves both packages). The reference computes LPIPS through piqa (gflow/benchmark.py:204,221-230),
whose AlexNet-LPIPS is the standard Zhang et al. v0.1 metric. Its weights
come from two public torch files:

  1. the torchvision AlexNet backbone (``alexnet-owt-*.pth``), keys
     ``features.{0,3,6,8,10}.{weight,bias}`` (the classifier.* keys are
     unused by LPIPS), and
  2. the LPIPS linear calibration weights (``lpips/weights/v0.1/alex.pth``
     in richzhang/PerceptualSimilarity), keys ``lin{0..4}.model.1.weight``
     with shapes (1, C_i, 1, 1), C = (64, 192, 384, 256, 256).

``convert(...)`` maps either/both onto the flat layout that
eval/metrics.py's LPIPS consumes (conv{i}_w (O,I,kh,kw), conv{i}_b (O,),
lin{i}_w (1,C,1,1)) and refuses to emit an incomplete file.

CLI:  python -m gflow_tpu_torch.cli.convert_lpips --alexnet-path a.pth \
          --lins-path alex.pth --out-path lpips_alex.npz
"""
from __future__ import annotations

import numpy as np

# torchvision AlexNet `features` indices of the 5 conv layers, in order
_FEATURE_IDX = (0, 3, 6, 8, 10)
_LIN_CH = (64, 192, 384, 256, 256)
_CONV_SHAPES = (
    (64, 3, 11, 11),
    (192, 64, 5, 5),
    (384, 192, 3, 3),
    (256, 384, 3, 3),
    (256, 256, 3, 3),
)


def expected_torch_keys() -> dict:
    """torch key -> shape for the full AlexNet-LPIPS parameter set."""
    keys = {}
    for i, fi in enumerate(_FEATURE_IDX):
        keys[f"features.{fi}.weight"] = _CONV_SHAPES[i]
        keys[f"features.{fi}.bias"] = (_CONV_SHAPES[i][0],)
    for i, c in enumerate(_LIN_CH):
        keys[f"lin{i}.model.1.weight"] = (1, c, 1, 1)
    return keys


def convert(alexnet_sd: dict | None = None, lins_sd: dict | None = None,
            merged_sd: dict | None = None) -> dict:
    """Build the flat LPIPS weight dict from torch state dicts.

    Accepts the two separate public files and/or one merged dict (e.g. the
    piqa/lpips package re-export, where backbone keys may be prefixed with
    ``net.`` and lins may appear as ``lins.{i}.model.1.weight``).
    Raises KeyError listing anything missing.
    """
    sd = {}
    for d in (alexnet_sd, lins_sd, merged_sd):
        if d:
            sd.update({k: np.asarray(v) for k, v in d.items()})

    def find(*names):
        for n in names:
            for k in (n, f"net.{n}", f"net.model.{n}"):
                if k in sd:
                    return sd[k]
        raise KeyError(f"LPIPS convert: none of {names} found "
                       f"(have {len(sd)} keys, e.g. {sorted(sd)[:4]})")

    out = {}
    for i, fi in enumerate(_FEATURE_IDX):
        w = find(f"features.{fi}.weight", f"slice{i+1}.{fi}.weight")
        b = find(f"features.{fi}.bias", f"slice{i+1}.{fi}.bias")
        if tuple(w.shape) != _CONV_SHAPES[i]:
            raise ValueError(
                f"conv{i} shape {w.shape} != expected {_CONV_SHAPES[i]}")
        out[f"conv{i}_w"] = w.astype(np.float32)
        out[f"conv{i}_b"] = b.astype(np.float32)
    for i, c in enumerate(_LIN_CH):
        w = find(f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                 f"lin{i}.model.0.weight")
        w = np.asarray(w, np.float32).reshape(1, c, 1, 1)
        # LPIPS lins are trained non-negative (clamped at use); clamp here
        # so the metric is faithful even if a raw file carries negatives.
        out[f"lin{i}_w"] = np.maximum(w, 0.0)
    return out


def save_npz(weights: dict, path: str):
    np.savez_compressed(path, **weights)


def convert_files(alexnet_path=None, lins_path=None, out_path="lpips_alex.npz"):
    import torch

    def load(p):
        if p is None:
            return None
        d = torch.load(p, map_location="cpu", weights_only=True)
        if hasattr(d, "state_dict"):
            d = d.state_dict()
        if "state_dict" in d and isinstance(d["state_dict"], dict):
            d = d["state_dict"]
        return {k: v.numpy() for k, v in d.items()}

    w = convert(load(alexnet_path), load(lins_path))
    save_npz(w, out_path)
    return out_path
