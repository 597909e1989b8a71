"""SSIM of the rgb loss (gflow_tpu_torch/ops/ssim.py) on the CPU.

The kernels (csrc/ssim.cu) run only on the card (tests/test_torch_cuda.py
holds them against the plain version there). Here: a CPU tensor takes the
plain version, bitwise the function the fit used before the kernels (the
frozen copy in bench_h100/reference/gs/losses.py); the analytic gradient
the backward kernel implements (three coefficient maps, blurred and
combined pointwise) equals autograd through the plain version in float64;
the kernel's taps and constants are the plain version's; the wrapper's
autograd glue, run on the CPU with the launches emulated by that analytic
math, passes the right arguments and gives autograd's gradient; and a
tensor off the CPU never reaches the plain version.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gflow_tpu_torch.eval import metrics
from gflow_tpu_torch.ops import _build
from gflow_tpu_torch.ops import ssim as ssim_ops
from gflow_tpu_torch.opt import losses

ROOT = Path(__file__).resolve().parent.parent
C1, C2 = 0.01**2, 0.03**2


def images(H, W, C, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(H, W, C, generator=g, dtype=torch.float64)
    y = (0.7 * x + 0.3 * torch.rand(H, W, C, generator=g, dtype=torch.float64)).clamp(0, 1)
    return x.to(dtype), y.to(dtype)


def frozen_losses():
    """The fit's loss module as it was before the kernels (a frozen copy)."""
    path = ROOT / "bench_h100" / "reference" / "gs" / "losses.py"
    spec = importlib.util.spec_from_file_location("_frozen_gs_losses", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blur(v):
    return ssim_ops._separable_blur(v, ssim_ops._ssim_window(11))


def coefficients(x, y):
    """S and the kernel's coefficient maps dS/dmu1, dS/dE[x^2], dS/dE[xy]
    (mu1, E[x^2], E[xy] taken as independent variables), in x's dtype."""
    mu1, mu2, e11, e22, e12 = (blur(m) for m in (x, y, x * x, y * y, x * y))
    A1 = 2 * mu1 * mu2 + C1
    A2 = 2 * (e12 - mu1 * mu2) + C2
    B1 = mu1 * mu1 + mu2 * mu2 + C1
    B2 = (e11 - mu1 * mu1) + (e22 - mu2 * mu2) + C2
    S = A1 * A2 / (B1 * B2)
    d_mu1 = 2 * mu2 * (A2 - A1) / (B1 * B2) + 2 * mu1 * S * (1 / B2 - 1 / B1)
    return S, torch.stack([d_mu1, -S / B2, 2 * A1 / (B1 * B2)])


def analytic_grad(x, y, coef, g=1.0):
    """d(g mean S)/dx: blur(dS/dmu1) + 2x blur(dS/dE[x^2]) + y blur(dS/dE[xy]),
    over H W C (the blur is its own transpose)."""
    a, b, c = (blur(m) for m in coef)
    return g * (a + 2 * x * b + y * c) / x.numel()


@pytest.mark.parametrize("shape", [(37, 23, 3), (7, 5, 1), (48, 40, 3)])
def test_cpu_tensor_takes_the_plain_version(shape):
    x, y = images(*shape)
    got = ssim_ops.ssim(x, y)
    assert losses.ssim is ssim_ops.ssim
    assert torch.equal(got, ssim_ops.ssim_plain(x, y))
    assert torch.equal(got, frozen_losses().ssim(x, y))
    assert float(ssim_ops.ssim(x, x)) == pytest.approx(1.0, abs=1e-5)
    # the eval's metric goes through the same routing
    assert metrics.ssim_metric(x.numpy(), y.numpy(), device="cpu") == float(got)


@pytest.mark.parametrize("shape", [(37, 23, 3), (7, 5, 1), (3, 2, 2), (26, 31, 8)])
def test_analytic_backward_equals_autograd(shape):
    """The gradient the backward kernel computes, in float64 with the plain
    blur, against autograd through the plain version: equal to 1e-12 of the
    largest entry (rounding of float64 alone)."""
    x, y = images(*shape, seed=sum(shape), dtype=torch.float64)
    x.requires_grad_()
    want = torch.autograd.grad(ssim_ops.ssim_plain(x, y), x)[0]
    S, coef = coefficients(x.detach(), y)
    assert float(S.mean()) == pytest.approx(float(ssim_ops.ssim_plain(x.detach(), y)),
                                            abs=1e-14)
    got = analytic_grad(x.detach(), y, coef)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_analytic_backward_camera_only_mask():
    """The camera-only stage's input, both images zero over the moving
    region: the gradient as autograd's."""
    x, y = images(40, 36, 3, seed=5, dtype=torch.float64)
    keep = torch.ones(40, 36, 1, dtype=torch.float64)
    keep[10:30, 8:28] = 0
    x, y = x * keep, y * keep
    x.requires_grad_()
    want = torch.autograd.grad(ssim_ops.ssim_plain(x, y), x)[0]
    got = analytic_grad(x.detach(), y, coefficients(x.detach(), y)[1])
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_kernel_constants_are_the_plain_versions():
    """csrc/ssim.cu's taps are _ssim_window(11) exactly, its C1 and C2 the
    plain version's as float32, its tile the wrapper's."""
    src = (ROOT / "gflow_tpu_torch" / "csrc" / "ssim.cu").read_text()
    body = re.search(r"kW\[kTaps\] = \{([^}]*)\}", src).group(1)
    taps = [float.fromhex(t.strip().rstrip("f")) for t in body.split(",")]
    assert taps == ssim_ops._ssim_window(11)
    consts = dict(re.findall(r"constexpr float (kC[12]) = ([0-9.e-]+)f;", src))
    assert np.float32(float(consts["kC1"])) == np.float32(C1)
    assert np.float32(float(consts["kC2"])) == np.float32(C2)
    tile = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(tile["kTW"]), int(tile["kTH"])) == (ssim_ops.TILE_W, ssim_ops.TILE_H)
    assert int(tile["kMaxC"]) == ssim_ops.MAX_CHANNELS and int(tile["kR"]) == 5


class Emulated:
    """_build.launch for ssim_fwd / ssim_bwd on CPU tensors, by the analytic
    math: checks the arguments the wrapper passes, then writes what the
    kernels write."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append(name)
        if name == "ssim_fwd":
            x, y, H, W, C, sx, sy, partial, n_partial, out, coef = args
            assert (H, W, C) == x.shape == y.shape
            assert sx == x.stride(1) and sy == y.stride(1) and x.stride(2) == 1
            assert n_partial == partial.numel() == -(-W // 32) * -(-H // 16)
            S, maps = coefficients(x, y)
            out.fill_(float(S.double().mean()))
            if isinstance(coef, torch.Tensor):
                coef.copy_(maps)
        else:
            assert name == "ssim_bwd"
            x, y, coef, g, H, W, C, sx, sy, dx = args
            assert g.shape == (1,) and dx.is_contiguous() and dx.shape == (H, W, C)
            dx.copy_(analytic_grad(x, y, coef, float(g[0])))


@pytest.mark.parametrize("layout", ["contiguous", "channel_slice"])
def test_autograd_glue_with_emulated_kernels(monkeypatch, layout):
    """_SSIM.apply on the CPU with the launches emulated: the value and
    dL/dimg1 of 1 - SSIM as autograd's through the plain version (float32:
    to 1e-5 of the largest entry, the rounding of two orders of the same
    float32 sums), img2 without a gradient; under no_grad the forward
    writes no coefficient maps."""
    emu = Emulated()
    monkeypatch.setattr(_build, "launch", emu)
    x, y = images(37, 23, 3, seed=3)
    if layout == "channel_slice":  # the render's rgb: a slice of (H, W, 4)
        x = torch.cat([x, torch.rand(37, 23, 1)], -1)[..., :3]
    leaf = x.detach().requires_grad_()
    loss = 1.0 - ssim_ops._SSIM.apply(leaf, y)
    got = torch.autograd.grad(loss, leaf)[0]
    assert emu.calls == ["ssim_fwd", "ssim_bwd"]
    ref = x.detach().requires_grad_()
    ref_loss = 1.0 - ssim_ops.ssim_plain(ref, y)
    want = torch.autograd.grad(ref_loss, ref)[0]
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), abs=1e-6)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    seen = []
    monkeypatch.setattr(_build, "launch", lambda name, *a: seen.append(a[-1]))
    with torch.no_grad():
        ssim_ops.ssim_fwd(leaf, y, with_coef=False)
    assert seen == [0]


def test_tensor_off_the_cpu_never_takes_the_plain_version():
    """A tensor on another device goes to the kernels or raises: on the meta
    device the launch refuses it (no CUDA device); img2 requiring a
    gradient, another window, a shape the kernels do not take, raise."""
    x = torch.empty(16, 20, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ssim_ops.ssim(x, x.clone())
    with pytest.raises(ValueError, match="img2"):
        ssim_ops.ssim(x, x.clone().requires_grad_())
    with pytest.raises(ValueError, match="window"):
        ssim_ops.ssim(x, x.clone(), window_size=7)
    with pytest.raises(ValueError, match="C <= 8"):
        wide = torch.empty(16, 20, 9, device="meta")
        ssim_ops.ssim(wide, wide.clone())
    with pytest.raises(ValueError, match="one shape"):
        ssim_ops.ssim(x, torch.empty(16, 21, 3, device="meta"))
