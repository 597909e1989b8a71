"""Whole runs of each cell at a tiny size on the CPU: the result's keys and
order, the per-layer metrics of a traced run, correct on a sound program;
and the fit driver's trainer calls and checkpoints equal fit_video's."""
import json
import subprocess
import sys

import numpy as np
import pytest

from harness import manifest
from tiny import TINY, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_untraced_run_reports_end_to_end_metrics(cell):
    rec = tiny_run(cell)
    assert list(rec) == KEYS and rec["correct"] is True
    want = {m["name"] for m in manifest.metrics_of(manifest.benchmark(), cell, False)}
    assert set(rec["metrics"]) == want
    for m in rec["metrics"].values():
        assert m["value"] > 0 and manifest.UNIT.match(m["unit"])
    assert set(rec["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in rec["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run_reports_per_layer_metrics(cell):
    rec = tiny_run(cell, trace=True)
    assert list(rec) == KEYS[:5] + ["breakdown", "checks"]
    names = {m["name"] for m in manifest.metrics_of(manifest.benchmark(), cell, True)}
    # the CPU has no device trace: those readers find nothing and are left
    # out; a cell BENCHMARK.json does not list reports none
    assert set(rec["metrics"]) <= names and bool(rec["metrics"]) == bool(names)
    assert {"busy_s", "window_s"} <= set(rec["device"])
    assert set(rec["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(tmp_path):
    """Without a card the command exits nonzero and prints no result."""
    p = subprocess.run([sys.executable, str(manifest.BENCH / "run.py"), "--workload",
                        "fit-davis480-moving", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=manifest.ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_fit_driver_makes_fit_videos_trainer_calls(tmp_path, monkeypatch):
    """fit_video.main and the driver, on one tiny periodic video: the same
    trainer.train calls in the same order and the same checkpoints."""
    import run as bench_run
    from gflow_tpu_torch.pipeline import fit_video
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer
    from scene.sequence import Sequence, write_sequence

    traffic, config = TINY["fit-davis480-moving"]
    traffic = dict(manifest.workload("fit-davis480-moving")["traffic"], **traffic)
    a = bench_run._merged(manifest.config("davis480-fit"), config)["fit_video"]
    seed = 2 ** 31 + 3
    calls = []
    orig = GFlowTrainer.train

    def recorded(self, **kw):
        out = orig(self, **kw)
        calls.append((kw, {k: np.asarray(v.detach().cpu()) for k, v in
                           self.params._asdict().items()}))
        return out

    monkeypatch.setattr(GFlowTrainer, "train", recorded)
    seq = write_sequence(Sequence(traffic, seed), tmp_path / "v")
    keys = ("num_points", "iterations_first", "iterations_after", "lr", "lr_camera", "lr_after",
            "lr_camera_after", "lambda_rgb", "lambda_depth", "lambda_still", "lambda_scale",
            "lambda_flow", "background", "camera_first", "iterations_camera", "densify_times",
            "densify_interval", "densify_times_after", "densify_interval_after", "lambda_var",
            "resize", "depth_offset", "traj_num", "traj_offset", "logs_suffix", "common_logs",
            "load_extr", "densify_occ_percent", "densify_err_thre", "densify_err_percent",
            "rebin_every")
    fit_video.main(sequence_path=seq, frame_range=3, seed=seed % 2 ** 63, device="cpu",
                   **{k: a[k] for k in keys})
    want, calls[:] = list(calls), []
    rec = bench_run.run_cell("fit-davis480-moving", seed, 0.0, False, device="cpu",
                             traffic_overrides=TINY["fit-davis480-moving"][0],
                             config_overrides=config)
    assert rec["correct"]
    got = calls
    # frame 0, the warm frame 1 (the CPU records no graph, so one warm
    # frame) and the window's frame 2: fit_video's frames 0-2
    assert len(got) == len(want) == 1 + 2 * 2
    for (kw_g, p_g), (kw_w, p_w) in zip(got, want):
        kw_g, kw_w = dict(kw_g), dict(kw_w)
        for kw in (kw_g, kw_w):
            for k in ("move_mask", "mask"):
                kw[k] = None if kw.get(k) is None else np.asarray(kw[k]).tolist()
        assert json.dumps(kw_g, sort_keys=True, default=str) == json.dumps(
            kw_w, sort_keys=True, default=str)
        for k in p_w:
            assert np.array_equal(p_g[k], p_w[k]), k
