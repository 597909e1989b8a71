"""Port parity: the benchmark (gflow_tpu_torch.eval.benchmark and
benchmark_multi) against gflow_tpu.eval's on the CPU, on a log directory
written by hand beside a tests/synth.make_sequence sequence (moving camera,
so ATE and RPE are not 0): three checkpoints in the npz schema of the
port's save_checkpoint (pipeline/trainer.py) from seeded Gaussians, with
renders in images/ and move masks in images_seg/. No fit runs.

The Gaussians' depths are distinct (evenly spaced, shuffled) and the
checkpoints' cameras only translate: tied sort keys order differently in
the two packages (ROADMAP, Queue 3). LPIPS runs with random weights
(through $GFLOW_LPIPS_WEIGHTS).

Tolerances and why:
- PSNR: the ground truth is resized (to 480 and back to the render's
  size) by jax.image.resize in one package and torch's antialiased
  interpolate in the other, equal to float32 rounding, which moves PSNR
  by ~2e-9 relative: 1e-7 relative;
- SSIM 1e-5 (float32 sums in another order), LPIPS atol 1e-5 / rtol
  1e-4 (tests/test_lpips_torch_parity.py);
- J, F, ATE, RPE: NumPy on the same files, 1e-9;
- OA, AJ, APTS: equal. The tracking suite renders each checkpoint through
  each package's rasterizer (1e-6 apart); a query could flip only if its
  nearest Gaussian or its 0.05 depth test sat on a tie at that scale,
  which these inputs do not have."""
import os
import shutil

import numpy as np
import pytest
import torch

from gflow_tpu.eval.benchmark import main as jax_main
from gflow_tpu.eval.benchmark_multi import main as jax_multi
from gflow_tpu_torch.core.io import imwrite, load_image
from gflow_tpu_torch.eval import lpips_convert
from gflow_tpu_torch.eval.benchmark import main as port_main
from gflow_tpu_torch.eval.benchmark_multi import main as port_multi
from gflow_tpu_torch.eval.metrics import LPIPS_WEIGHTS_ENV
from gflow_tpu_torch.utils.cli import run_cli
from tests.synth import make_sequence

W, H, N, T = 96, 64, 400, 3
FOCAL = 80.0
EXACT = ("Occlusion_Accuracy", "Average_Jaccard", "Average_PTS_within_threshold")
TOL = {"PSNR": (1e-7, 0.0), "SSIM": (0.0, 1e-5), "LPIPS": (1e-4, 1e-5),
       **{k: (0.0, 1e-9) for k in ("J_zero", "F_zero", "J&F_zero", "ATE", "RPE_t", "RPE_r")},
       **{k: (0.0, 0.0) for k in EXACT}}


def write_run(seq, run_dir, seed=0):
    """fit_video's log layout for the frames of `seq`: ckpt/<frame>.npz,
    images/img_<frame>.png (the frame plus noise) and
    images_seg/move_mask[_erode]_<frame>.png (the epipolar mask shifted by
    a pixel)."""
    rng = np.random.default_rng(seed)
    for sub in ("ckpt", "images", "images_seg"):
        os.makedirs(os.path.join(run_dir, sub))
    z = (1.6 + 0.8 * rng.permutation(N) / N).astype(np.float32)
    u, v = rng.uniform(-4, W + 4, N), rng.uniform(-4, H + 4, N)
    xyz0 = np.c_[(u - W / 2) * z / FOCAL, (v - H / 2) * z / FOCAL, z].astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    params = dict(scale=f32(rng.uniform(0.01, 0.03, (N, 3))),
                  rotate=f32(rng.normal(size=(N, 4))),
                  opacity=f32(rng.uniform(0.5, 3.0, (N, 1))),
                  rgb=f32(rng.normal(0, 1.5, (N, 3))))
    for t in range(T):
        name = f"{t:05d}"
        extr = f32(np.c_[np.eye(3), [0.02 * t, 0.008 * t, 0.0] + rng.normal(0, 0.004, 3)])
        xyz = xyz0 + f32([0.01 * t, 0.0, 0.0]) * (np.arange(N) % 3 == 0)[:, None]
        np.savez(os.path.join(run_dir, "ckpt", f"{name}.npz"), xyz=xyz, **params,
                 intr=f32([FOCAL, FOCAL, W / 2, H / 2]), extr=extr,
                 still_mask=rng.uniform(size=N) < 0.7, last_uv=f32(rng.uniform(0, W, (N, 2))),
                 move_seg=np.zeros(0), width=W, height=H)
        frame = load_image(os.path.join(seq, f"{name}.png"))
        noisy = np.clip(frame + rng.normal(0, 0.05, frame.shape), 0, 1)
        imwrite(os.path.join(run_dir, "images", f"img_{name}.png"),
                (noisy * 255).astype(np.uint8))
        mask = load_image(str(seq) + f"_epipolar/{name}_open.png")[..., 0] > 0.5
        for nm, m in (("move_mask", np.roll(mask, 1, axis=1)), ("move_mask_erode", mask)):
            imwrite(os.path.join(run_dir, "images_seg", f"{nm}_{name}.png"),
                    (m * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    rng = np.random.default_rng(5)
    sd = {k: rng.normal(0, 0.05, s).astype(np.float32)
          for k, s in lpips_convert.expected_torch_keys().items()}
    sd = {k: np.abs(v) if k.endswith(".bias") else v for k, v in sd.items()}
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    lpips_convert.save_npz(lpips_convert.convert(merged_sd=sd), str(path))
    return str(path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    seq = make_sequence(root, n_frames=T, W=W, H=H, moving_camera=True)
    run = root / "logs" / "run"
    write_run(seq, str(run))
    return seq, run


def assert_metrics_match(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert w is not None, k  # every suite produced its metric
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def test_benchmark_matches_jax(scene, lpips_weights, monkeypatch):
    seq, run = scene
    monkeypatch.setenv(LPIPS_WEIGHTS_ENV, lpips_weights)
    want = jax_main(log_path=str(run), sequence_path=str(seq), csv_name="jax")
    got = port_main(log_path=str(run), sequence_path=str(seq), csv_name="port", device="cpu")
    assert set(want) == set(TOL)
    assert_metrics_match(got, want)
    # the tracking suite scored something: not all-right or all-wrong
    assert 0 < got["Average_Jaccard"] < 100 and got["ATE"] > 1e-4 and got["RPE_r"] > 0
    rows = [line.split(",")[0] for line in open(run / "port.csv")]
    assert rows == list(got)


def test_benchmark_without_lpips_weights_adds_the_note(scene, monkeypatch):
    seq, run = scene
    monkeypatch.delenv(LPIPS_WEIGHTS_ENV, raising=False)
    got = port_main(log_path=str(run), sequence_path=str(seq), csv_name="nolpips",
                    eval_track=False, eval_seg=False, eval_camera_flag=False, device="cpu")
    want = jax_main(log_path=str(run), sequence_path=str(seq), csv_name="nolpips_jax",
                    eval_track=False, eval_seg=False, eval_camera_flag=False)
    assert got["LPIPS"] is None and got["LPIPS_note"] == want["LPIPS_note"]


def dataset(root, seq, names=("bear", "cows"), suffix="logs"):
    """benchmark_multi's layout: <root>/<name>/<name> (the sequence and its
    prior folders) and <root>/<name>/<name>_<suffix>/0_latest/<run>."""
    seq_parent = os.path.dirname(seq)
    for i, name in enumerate(names):
        os.makedirs(root / name)
        for entry in os.listdir(seq_parent):
            if entry.startswith("synth"):
                shutil.copytree(os.path.join(seq_parent, entry),
                                root / name / entry.replace("synth", name, 1))
        write_run(root / name / name, str(root / name / f"{name}_{suffix}" / "0_latest"
                                          / "2026_01_01-00_00_00"), seed=i + 1)
    return root


def read_csv(path):
    lines = [line.rstrip("\n").split(",") for line in open(path)]
    return lines[0], {row[0]: row[1:] for row in lines[1:]}


def test_benchmark_multi_writes_the_same_rows(scene, lpips_weights, tmp_path, monkeypatch):
    monkeypatch.setenv(LPIPS_WEIGHTS_ENV, lpips_weights)
    root = dataset(tmp_path, scene[0])
    jax_multi(str(root), log_suffix="logs")
    head_j, rows_j = read_csv(root / "metrics.csv")
    port_multi(str(root), log_suffix="logs", device="cpu")
    head_t, rows_t = read_csv(root / "metrics.csv")
    assert head_t == head_j and sorted(rows_t) == sorted(rows_j) == ["Average", "bear", "cows"]
    for name, row in rows_j.items():
        for k, w, g in zip(head_j[1:], row, rows_t[name]):
            rtol, atol = TOL[k]
            np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")


def test_benchmark_multi_averages_skip_the_note(scene, tmp_path, monkeypatch):
    """Without LPIPS weights each row carries LPIPS_note (text): the port
    averages the numbers and leaves that column's average None."""
    monkeypatch.delenv(LPIPS_WEIGHTS_ENV, raising=False)
    monkeypatch.setattr("gflow_tpu_torch.eval.benchmark.eval_tracking",
                        lambda *a, **k: (None, None, None))
    root = dataset(tmp_path, scene[0])
    res = port_multi(str(root), log_suffix="logs", device="cpu")
    head, rows = read_csv(root / "metrics.csv")
    note = head.index("LPIPS_note") - 1
    assert rows["Average"][note] == "None" and rows["bear"][note] == res["bear"]["LPIPS_note"]
    psnr = head.index("PSNR") - 1
    assert float(rows["Average"][psnr]) == pytest.approx(
        (res["bear"]["PSNR"] + res["cows"]["PSNR"]) / 2)


def test_cli_and_the_device_rule(scene, monkeypatch):
    """The CLI takes --device; without CUDA and without a device the
    entry points raise rather than run on the CPU."""
    seq, run = scene
    got = run_cli(port_main, argv=["--log-path", str(run), "--sequence-path", str(seq),
                                   "--csv-name", "cli", "--no-eval-recon", "--no-eval-track",
                                   "--device", "cpu"])
    assert got["J_zero"] is not None and os.path.exists(run / "cli.csv")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(log_path=str(run), sequence_path=str(seq), csv_name="x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_multi(str(run))
