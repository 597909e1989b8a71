"""Port parity: gflow_tpu_torch.eval (tapvid, davis, camera_eval, metrics,
lpips_convert) against gflow_tpu.eval on the CPU, on the same inputs made
with NumPy from a seed.

Tolerances and why:
- the NumPy metrics (TAP-Vid in both query modes, J, F, ATE, RPE,
  Umeyama, PSNR) are copies of the JAX package's: equal to 1e-12;
- SSIM: the port's separable blur against the JAX package's, float32
  sums in another order: 1e-5;
- LPIPS(Alex) with random weights through both packages' converters:
  atol 1e-5 / rtol 1e-4, the tolerance of tests/test_lpips_torch_parity.py
  (float32 convolutions in another order); identical images < 1e-7."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gflow_tpu.eval import camera_eval as j_camera, davis as j_davis, metrics as j_metrics
from gflow_tpu.eval import lpips_convert as j_convert, tapvid as j_tapvid
from gflow_tpu_torch.eval import camera_eval as t_camera, davis as t_davis, metrics as t_metrics
from gflow_tpu_torch.eval import lpips_convert as t_convert, tapvid as t_tapvid

JAX = SimpleNamespace(tapvid=j_tapvid, davis=j_davis, camera=j_camera, metrics=j_metrics)
PORT = SimpleNamespace(tapvid=t_tapvid, davis=t_davis, camera=t_camera, metrics=t_metrics)


def tapvid_inputs(rng, B=2, Q=12, T=8):
    gt = rng.uniform(0, 255, (B, Q, T, 2))
    pred = gt + rng.normal(0, 5, gt.shape)
    q = np.stack([rng.integers(0, T, (B, Q)), rng.uniform(0, 255, (B, Q)),
                  rng.uniform(0, 255, (B, Q))], -1)
    return q, rng.uniform(size=(B, Q, T)) < 0.2, gt, rng.uniform(size=(B, Q, T)) < 0.25, pred


def masks(rng, shape=(64, 80)):
    """Two overlapping blob masks (smoothed noise, thresholded)."""
    a = gaussian_filter(rng.normal(size=shape), 4) > 0
    b = gaussian_filter(rng.normal(size=shape), 4) + 0.5 * a > 0.1
    return a, b


def trajectories(rng, T=12):
    """A random walk of c2w poses and a perturbed, Sim(3)-moved copy."""
    def pose(axis_angle, t):
        th = np.linalg.norm(axis_angle)
        k = np.cross(np.eye(3), axis_angle / th)
        R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        return np.block([[R, t[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]])

    gt = np.stack([pose(rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3) * i) for i in range(T)])
    est = np.stack([pose(rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3) * i) for i in range(T)])
    est = 0.5 * gt + 0.5 * est
    return gt, est


def images(rng, shape=(48, 64, 3)):
    a = rng.uniform(0, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.08, shape), 0, 1).astype(np.float32)


CASES = {
    "tapvid_first": lambda p, rng: p.tapvid.compute_tapvid_metrics(*tapvid_inputs(rng), "first"),
    "tapvid_strided": lambda p, rng: p.tapvid.compute_tapvid_metrics(*tapvid_inputs(rng),
                                                                     "strided"),
    "jaccard_iou": lambda p, rng: p.davis.jaccard_iou(*masks(rng)),
    "boundary_f_measure": lambda p, rng: p.davis.boundary_f_measure(*masks(rng)),
    "ate_rmse": lambda p, rng: p.camera.ate_rmse(*(x[:, :3, 3] for x in trajectories(rng))),
    "rpe": lambda p, rng: p.camera.rpe(*trajectories(rng)),
    "umeyama_alignment": lambda p, rng: p.camera.umeyama_alignment(
        *(x[:, :3, 3] for x in trajectories(rng))),
    "psnr": lambda p, rng: p.metrics.psnr(*images(rng)),
}


def flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in flat(e)]
    return list(np.ravel(np.asarray(x, np.float64)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_metrics_match_jax(case):
    want = CASES[case](JAX, np.random.default_rng(0))
    got = CASES[case](PORT, np.random.default_rng(0))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
    w = flat(want)
    assert len(w) > 0 and not np.allclose(w, 0)  # a real value, not a degenerate one
    np.testing.assert_allclose(flat(got), w, rtol=0, atol=1e-12)


def test_ssim_matches_jax():
    a, b = images(np.random.default_rng(1), (40, 56, 3))
    got = t_metrics.ssim_metric(a, b, device="cpu")
    assert got == pytest.approx(j_metrics.ssim_metric(a, b), abs=1e-5)
    assert t_metrics.ssim_metric(a, a, device="cpu") == pytest.approx(1.0, abs=1e-5)


def torch_state_dict(seed=0):
    """Random LPIPS(Alex) weights under the released torch key names,
    biases positive so the relu features are not degenerate, lins
    non-negative (as trained)."""
    rng = np.random.default_rng(seed)
    sd = {k: rng.normal(0, 0.05, s).astype(np.float32)
          for k, s in t_convert.expected_torch_keys().items()}
    for k in sd:
        if k.endswith(".bias") or k.startswith("lin"):
            sd[k] = np.abs(sd[k])
    return sd


@pytest.mark.parametrize("shape", [(64, 96), (67, 90)])
def test_lpips_matches_jax(shape):
    sd = torch_state_dict()
    w_jax, w_port = j_convert.convert(merged_sd=sd), t_convert.convert(merged_sd=sd)
    assert sorted(w_port) == sorted(w_jax)
    for k in w_jax:
        np.testing.assert_array_equal(w_port[k], w_jax[k], err_msg=k)
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (*shape, 3)).astype(np.float32)
    for b in (np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32),
              np.clip(1 - a, 0, 1)):
        want = j_metrics.lpips(a, b, weights={k: jnp.asarray(v) for k, v in w_jax.items()})
        got = t_metrics.lpips(a, b, weights=w_port, device="cpu")
        assert want > 0
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert abs(t_metrics.lpips(a, a, weights=w_port, device="cpu")) < 1e-7


def test_lpips_weights_file_and_gating(tmp_path, monkeypatch):
    """The weights file through $GFLOW_LPIPS_WEIGHTS gives the explicit
    weights' value; no weights gives None; an incomplete state dict makes
    convert raise."""
    sd = torch_state_dict(1)
    w = t_convert.convert(merged_sd=sd)
    rng = np.random.default_rng(3)
    a, b = images(rng, (40, 48, 3))
    monkeypatch.delenv(t_metrics.LPIPS_WEIGHTS_ENV, raising=False)
    assert t_metrics.load_lpips_weights() is None
    assert t_metrics.lpips(a, b, device="cpu") is None
    path = tmp_path / "lpips.npz"
    t_convert.save_npz(w, str(path))
    monkeypatch.setenv(t_metrics.LPIPS_WEIGHTS_ENV, str(path))
    assert t_metrics.lpips(a, b, device="cpu") == t_metrics.lpips(a, b, w, device="cpu")
    monkeypatch.setenv(t_metrics.LPIPS_WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    assert t_metrics.load_lpips_weights() is None
    with pytest.raises(KeyError):
        t_convert.convert(merged_sd={k: v for k, v in sd.items() if not k.startswith("lin3")})


def test_lpips_convolutions_run_without_tf32(monkeypatch):
    """Every LPIPS convolution sees cudnn.allow_tf32 False, and the
    caller's global flag is left as it was."""
    seen, conv2d = [], torch.nn.functional.conv2d

    def record(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", record)
    before = torch.backends.cudnn.allow_tf32
    a, b = images(np.random.default_rng(4), (40, 48, 3))
    t_metrics.lpips(a, b, t_convert.convert(merged_sd=torch_state_dict()), device="cpu")
    assert seen == [False] * 10
    assert torch.backends.cudnn.allow_tf32 == before
