"""Port parity: split_tapvid (gflow_tpu_torch.pipeline.split_tapvid vs
gflow_tpu.pipeline.split_tapvid) on a seeded TAP-Vid-style pickle, on the
CPU. The port writes the frames through PIL, the JAX package through
imageio, whose JPEG plugin calls PIL at the same default quality: the
files are byte-equal (as tests/test_torch_io.py holds imwrite). The
tracking.pkl holds equal arrays. Also the CLI."""
import os
import pickle

import numpy as np

from gflow_tpu.pipeline.split_tapvid import main as jax_split
from gflow_tpu_torch.core.io import load_image
from gflow_tpu_torch.pipeline.split_tapvid import main as port_split
from gflow_tpu_torch.utils.cli import run_cli


def tapvid_pickle(path, scenes=(("bear", 3), ("cows", 2)), H=40, W=56, Q=5):
    rng = np.random.default_rng(0)
    data = {}
    for name, T in scenes:
        yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
        frames = [np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx + t)], -1) for t in range(T)]
        video = np.clip(np.stack(frames) + rng.normal(0, 0.03, (T, H, W, 3)), 0, 1)
        data[name] = {"video": (video * 255).astype(np.uint8),
                      "points": rng.uniform(0, 1, (Q, T, 2)).astype(np.float32),
                      "occluded": rng.uniform(size=(Q, T)) < 0.3}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


def test_split_tapvid_matches_jax(tmp_path):
    data = tapvid_pickle(tmp_path / "tapvid.pkl")
    assert port_split(str(tmp_path / "tapvid.pkl"), str(tmp_path / "port")) == str(
        tmp_path / "port")
    jax_split(str(tmp_path / "tapvid.pkl"), str(tmp_path / "jax"))
    for name, payload in data.items():
        d_port, d_jax = tmp_path / "port" / name / name, tmp_path / "jax" / name / name
        files = sorted(os.listdir(d_jax))
        assert sorted(os.listdir(d_port)) == files
        assert files == [f"{t:05d}.jpg" for t in range(len(payload["video"]))] + ["tracking.pkl"]
        for f in files[:-1]:
            assert (d_port / f).read_bytes() == (d_jax / f).read_bytes(), f
            frame = load_image(d_port / f) * 255
            assert np.abs(frame - payload["video"][int(f[:5])]).mean() < 10  # a JPEG of it
        with open(d_port / "tracking.pkl", "rb") as fp, open(d_jax / "tracking.pkl", "rb") as fj:
            got, want = pickle.load(fp), pickle.load(fj)
        assert sorted(got) == sorted(want) == ["occluded", "points"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_cli(tmp_path):
    tapvid_pickle(tmp_path / "t.pkl", scenes=(("dog", 2),))
    run_cli(port_split, argv=["--pkl-path", str(tmp_path / "t.pkl"),
                              "--out-root", str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path / "out" / "dog" / "dog")) == [
        "00000.jpg", "00001.jpg", "tracking.pkl"]
