"""Image quality metrics — PSNR / SSIM / LPIPS.

Counterpart of ``gflow_tpu/eval/metrics.py``. PSNR is NumPy; SSIM is the
port's ``opt.losses.ssim`` (window 11, sigma 1.5; ``ops/ssim.py``: the
forward kernel on the card, the plain version on the CPU) on the given device;
LPIPS is the standard AlexNet-based metric as a ``torch.nn.Module`` built
from the flat weight dict that ``eval.lpips_convert`` writes. It is
weights-gated, as in the JAX package: without a weights file LPIPS is None
(no pretrained CNN weights ship with the repo, and none are downloaded).

The convolutions and max-pools are ``F.conv2d`` / ``F.max_pool2d`` (the JAX
package leaves them to XLA too). cuDNN would run a float32 convolution in
TF32 by default (``torch.backends.cudnn.allow_tf32``), about 1e-3 from the
float32 metric, so the forward runs under ``models.precision.fp32_math``
(TF32 off) without touching the caller's global flags.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models.precision import fp32_math
from ..opt.losses import ssim as _ssim


def psnr(img: np.ndarray, ref: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio over (H, W, C) images in [0, max_val]."""
    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def _image(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


@torch.no_grad()
def ssim_metric(img: np.ndarray, ref: np.ndarray, device=None) -> float:
    dev = resolve_device(device)
    return float(_ssim(_image(img, dev), _image(ref, dev)))


# ---------------------------------------------------------------------------
# LPIPS (AlexNet backbone): weights-gated
# ---------------------------------------------------------------------------

LPIPS_WEIGHTS_ENV = "GFLOW_LPIPS_WEIGHTS"

_ALEX_CFG = [  # (out_channels, kernel, stride, padding)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # maxpool after these conv indices (AlexNet features)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSAlex(torch.nn.Module):
    """LPIPS(Alex) v0.1 from the flat weight dict (conv{i}_w/b, lin{i}_w):
    the 5 ReLU feature maps of AlexNet's convolutions (max-pools after the
    first two), each unit-normalized over channels, squared differences
    weighted by the linear calibration, averaged over space, summed."""

    def __init__(self, weights: dict):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        """x: (1, 3, H, W) normalized; returns the 5 relu feature maps."""
        feats, h = [], x
        for i, (_, _, s, p) in enumerate(_ALEX_CFG):
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=s, padding=p))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, kernel_size=3, stride=2)
        return feats

    def prep(self, img) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> (1, 3, H, W), scaled to [-1, 1] and shifted."""
        x = _image(img, self.shift.device).permute(2, 0, 1)[None] * 2 - 1
        return (x - self.shift) / self.scale

    @torch.no_grad()
    def forward(self, img, ref) -> torch.Tensor:
        with fp32_math():
            fa, fb = self.features(self.prep(img)), self.features(self.prep(ref))
        total = torch.zeros((), device=self.shift.device)
        for i, (a, b) in enumerate(zip(fa, fb)):
            # upstream normalize_tensor: x / (||x|| + eps), eps OUTSIDE the sqrt
            a = a / (torch.sqrt(torch.sum(a**2, dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b**2, dim=1, keepdim=True)) + 1e-10)
            d = (a - b) ** 2
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}_w"), dim=1))
        return total


def load_lpips_weights(path: str | None = None) -> dict | None:
    """Load converted LPIPS(Alex) weights from an .npz (conv{i}_w/b +
    lin{i}_w) as NumPy arrays. Returns None when unavailable."""
    path = path or os.environ.get(LPIPS_WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def lpips(img: np.ndarray, ref: np.ndarray, weights=None, device=None) -> float | None:
    """LPIPS(Alex). Inputs (H, W, 3) in [0, 1]. `weights`: a flat weight
    dict, or an LPIPSAlex already on its device (a caller that scores many
    pairs builds it once); None reads $GFLOW_LPIPS_WEIGHTS. Returns None
    without weights."""
    if weights is None:
        weights = load_lpips_weights()
    if weights is None:
        return None
    net = weights if isinstance(weights, LPIPSAlex) else LPIPSAlex(weights).to(
        resolve_device(device))
    return float(net(img, ref))
