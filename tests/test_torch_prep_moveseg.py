"""Port parity: prep_moveseg (gflow_tpu_torch.pipeline.prep_moveseg) against
the JAX package's main on the CPU: the same three forward flows (rigid
scenes under a moving camera with a block moving against them, 96x128,
tests/test_torch_epipolar.scene_flow) beside a 4-frame sequence. The port
is handed JAX's LMedS draws (PRNGKey(0), as the JAX main draws), then
with its own (torch.Generator, seed 0). Also the CLI.

Tolerances: with JAX's draws, the error PNGs within one level (the
normalized maps agree to 1e-3, tests/test_torch_epipolar.py) and the
mask PNGs (open, erode, dilate) equal; with the port's own draws, the
masks equal but for at most 0.1% of pixels."""
import os

import numpy as np
import pytest
import torch

from gflow_tpu.pipeline.prep_moveseg import main as jax_main
from gflow_tpu_torch.core.io import imread, imwrite, write_flow
from gflow_tpu_torch.ops import epipolar
from gflow_tpu_torch.pipeline import prep_moveseg
from gflow_tpu_torch.utils.cli import run_cli
from tests.test_torch_epipolar import jax_draws, scene_flow
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 96, 128


def write_seq(root, n=4):
    seq = os.path.join(str(root), "seq")
    os.makedirs(seq)
    os.makedirs(seq + "_flow_unimatch")
    for t in range(n):
        imwrite(os.path.join(seq, f"{t:05d}.png"), np.full((H, W, 3), 40 * t, np.uint8))
        if t < n - 1:
            write_flow(os.path.join(seq + "_flow_unimatch", f"{t:05d}_pred.flo"),
                       scene_flow(H, W, seed=t)[0])
    return seq


TAGS = ("epipolar_error", "open", "erode", "dilate")


def pngs(seq, t):
    return {tag: imread(os.path.join(seq + "_epipolar", f"{t:05d}_{tag}.png")) for tag in TAGS}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    seq = write_seq(tmp_path_factory.mktemp("jax"))
    jax_main(seq)
    return seq


def test_main_with_jax_draws_matches_jax(tmp_path, jax_out, monkeypatch):
    monkeypatch.setattr(epipolar, "lmeds_draws", lambda N, *a, **k: jax_draws(N))
    seq = write_seq(tmp_path)
    assert prep_moveseg.main(seq, device="cpu") == seq + "_epipolar"
    for t in range(3):
        got, want = pngs(seq, t), pngs(jax_out, t)
        assert got["open"].shape == (H, W) and 0 < (got["open"] > 0).mean() < 0.2
        err_gap = np.abs(got["epipolar_error"].astype(int) - want["epipolar_error"])
        assert err_gap.max() <= 1
        for tag in TAGS[1:]:
            np.testing.assert_array_equal(got[tag], want[tag], err_msg=tag)


def test_main_with_own_draws_and_cli(tmp_path, jax_out):
    seq = write_seq(tmp_path)
    run_cli(prep_moveseg.main, ["--img-dir", seq, "--device", "cpu"])
    for t in range(3):
        got, want = pngs(seq, t), pngs(jax_out, t)
        for tag in TAGS[1:]:
            assert (got[tag] != want[tag]).mean() <= 1e-3, tag


def test_missing_flows_raise(tmp_path):
    os.makedirs(tmp_path / "seq")
    with pytest.raises(FileNotFoundError):
        prep_moveseg.main(str(tmp_path / "seq"), device="cpu")
    assert torch.equal(epipolar.lmeds_draws(100)[0], epipolar.lmeds_draws(100)[0])  # seeded
