"""SSIM of the fit's rgb loss and of the eval's metric (``csrc/ssim.cu``).

Mean SSIM of two (H, W, C) images in [0, 1]: window 11, sigma 1.5, zero
padding (gflow/utils/pytorch_ssim.py). ``ssim_plain`` is the five maps
(x, y, x^2, y^2, xy) blurred in one stacked separable pass of shifted
multiply-adds, differentiated by autograd; the counterpart of the JAX
package's ``gflow_tpu/opt/losses.py`` ``ssim``, which XLA fuses (there is
no Pallas kernel).

On CUDA tensors ``ssim`` runs the hand-written kernels instead: the
forward ``ssim_fwd`` (the blurred maps and the SSIM map equal the plain
version's bitwise, the mean is summed in another fixed order) and the
backward ``ssim_bwd`` (the analytic gradient: one blur of three
coefficient maps that the forward wrote, combined pointwise). Only the
first image gets a gradient; where it needs none (no grad mode, or a
tensor that does not require it) the forward writes no coefficient maps.
``ssim`` picks by device: a CPU tensor takes the plain version, any other
launches the kernels or raises; nothing falls back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

WINDOW = 11
TILE_W, TILE_H = 32, 16  # the kernels' output tile (csrc/ssim.cu kTW, kTH)
MAX_CHANNELS = 8


def _ssim_window(window_size: int = 11, sigma: float = 1.5) -> list[float]:
    g = np.asarray([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
                    for x in range(window_size)], np.float32)
    return (g / g.sum()).tolist()


def _separable_blur(x: torch.Tensor, w1d) -> torch.Tensor:
    """(H, W, C) -> same-size separable blur with zero padding, as k-tap
    shifted multiply-adds (the reference's form, kept instead of a
    convolution so the sums run in the same order)."""
    r = len(w1d) // 2

    def pass_axis(v, axis):
        n = v.shape[axis]
        pad = [0, 0] * v.ndim
        pad[2 * (v.ndim - 1 - axis)] = r
        pad[2 * (v.ndim - 1 - axis) + 1] = r
        vp = torch.nn.functional.pad(v, pad)
        out = None
        for i, wi in enumerate(w1d):
            term = wi * vp.narrow(axis, i, n)
            out = term if out is None else out + term
        return out

    return pass_axis(pass_axis(x, 0), 1)


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1] (window 11, sigma 1.5,
    zero-padded — gflow/utils/pytorch_ssim.py); the five blurred maps are
    computed in one stacked separable pass."""
    w1d = _ssim_window(window_size)
    x, y = img1, img2
    C = x.shape[-1]
    b = _separable_blur(torch.cat([x, y, x * x, y * y, x * y], dim=-1), w1d)
    mu1, mu2 = b[..., :C], b[..., C:2 * C]
    e_x2, e_y2, e_xy = b[..., 2 * C:3 * C], b[..., 3 * C:4 * C], b[..., 4 * C:]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e_x2 - mu1_sq
    sigma2_sq = e_y2 - mu2_sq
    sigma12 = e_xy - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def _pixel_stride(t: torch.Tensor, name: str) -> tuple[torch.Tensor, int]:
    """t as the kernels read it, with its pixels' stride in floats: channels
    contiguous and pixels evenly spaced (a channel slice of a wider image
    is read in place), else a contiguous copy."""
    H, W, C = t.shape
    if t.dtype != torch.float32:
        raise ValueError(f"ssim: {name} must be float32, got {t.dtype}")
    s = t.stride()
    if s[2] == 1 and s[1] >= C and s[0] == W * s[1]:
        return t, s[1]
    return t.contiguous(), C


def _check(img1: torch.Tensor, img2: torch.Tensor):
    if img1.dim() != 3 or img1.shape != img2.shape:
        raise ValueError(f"ssim: need two (H, W, C) images of one shape, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    H, W, C = img1.shape
    if H < 1 or W < 1 or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"ssim: need H, W >= 1 and 1 <= C <= {MAX_CHANNELS}, got "
                         f"{tuple(img1.shape)}")
    if img1.device != img2.device:
        raise ValueError("ssim: img1 and img2 must be on one device")


def ssim_fwd(x: torch.Tensor, y: torch.Tensor, with_coef: bool):
    """Launch ``ssim_fwd`` on CUDA tensors x, y (H, W, C). Returns the mean
    SSIM (a 0-d tensor) and, with_coef, the (3, H, W, C) coefficient maps
    dS/dmu1, dS/dE[x^2], dS/dE[xy] (else None)."""
    _check(x, y)
    H, W, C = x.shape
    x, sx = _pixel_stride(x, "img1")
    y, sy = _pixel_stride(y, "img2")
    n_partial = -(-W // TILE_W) * -(-H // TILE_H)
    partial = torch.empty(n_partial, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    coef = (torch.empty((3, H, W, C), dtype=torch.float32, device=x.device) if with_coef
            else None)
    _build.launch("ssim_fwd", x, y, H, W, C, sx, sy, partial, n_partial, out,
                  0 if coef is None else coef)
    return out, coef


def ssim_bwd(x: torch.Tensor, y: torch.Tensor, coef: torch.Tensor, g: torch.Tensor):
    """Launch ``ssim_bwd``: d(mean SSIM)/dx (H, W, C), contiguous, for the
    upstream gradient g (a one-element tensor on the card)."""
    _check(x, y)
    H, W, C = x.shape
    if coef.dtype != torch.float32 or coef.shape != (3, H, W, C) or not coef.is_contiguous():
        raise ValueError(f"ssim: coef must be a contiguous float32 (3, {H}, {W}, {C}) tensor")
    x, sx = _pixel_stride(x, "img1")
    y, sy = _pixel_stride(y, "img2")
    g = g.reshape(1).to(torch.float32).contiguous()
    dx = torch.empty((H, W, C), dtype=torch.float32, device=x.device)
    _build.launch("ssim_bwd", x, y, coef, g, H, W, C, sx, sy, dx)
    return dx


class _SSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2):
        out, coef = ssim_fwd(img1, img2, with_coef=True)
        ctx.save_for_backward(img1, img2, coef)
        return out

    @staticmethod
    def backward(ctx, g):
        img1, img2, coef = ctx.saved_tensors
        return ssim_bwd(img1, img2, coef, g), None


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images for their device: the plain
    version on the CPU, the ``ssim_fwd`` / ``ssim_bwd`` kernels on CUDA
    tensors (float32, 1 to 8 channels, any H and W; img2 gets no gradient:
    raises where it requires one)."""
    if img1.device.type == "cpu":
        return ssim_plain(img1, img2, window_size)
    if window_size != WINDOW:
        raise ValueError(f"ssim: the kernels take window {WINDOW}, got {window_size}")
    grad = torch.is_grad_enabled()
    if grad and img2.requires_grad:
        raise ValueError("ssim: the kernels give img1 alone a gradient; img2 requires one")
    if grad and img1.requires_grad:
        return _SSIM.apply(img1, img2)
    return ssim_fwd(img1, img2, with_coef=False)[0]
