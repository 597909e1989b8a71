"""Scene-parallel dataset sweeps: fit several sequences at once, one
worker process per device.

Counterpart of ``gflow_tpu/parallel/scene_sweep.py`` (the reference's only
multi-GPU story is bash loops over ``CUDA_VISIBLE_DEVICES``). A fit's loop
is host-bound (PERF.md section 5), so each device gets its own process and
with it its own host thread of control; threads in one interpreter would
share one interpreter lock. Workers start with ``spawn`` (CUDA cannot be
forked), each with its torch threads capped to its share of the cores;
the CUDA kernels are built once in the parent before the workers start,
so that the workers load the libraries instead of each running nvcc.
"""
from __future__ import annotations

import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import torch

from ..viz.colormap import print_color


def _fit_worker(jobs, device: str, threads: int):
    """Fit each (sequence, fit_video keyword arguments) of `jobs` in turn on
    `device`; returns {sequence: log_dir}. Runs in a spawned worker."""
    from ..pipeline.fit_video import main as fit_main

    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    results = {}
    for seq, kwargs in jobs:
        print_color(f"[sweep] {os.path.basename(str(seq))} -> {device}")
        results[str(seq)] = fit_main(sequence_path=seq, device=device, **kwargs).dir
    return results


def fit_scenes(scene_paths, fit_kwargs=None, devices=None, log_suffix="logs"):
    """Fit every sequence in `scene_paths` (each a <scene>/<scene> dir),
    round-robin over `devices` (default: every visible card; an entry may
    repeat, as two workers on one card), one spawned worker process per
    entry, which fits its scenes in turn. Returns {scene: log_dir}. A
    worker's exception is raised here."""
    devices = [str(d) for d in (devices or [f"cuda:{i}" for i in
                                            range(torch.cuda.device_count())])]
    if not devices:
        raise RuntimeError("no CUDA device visible: pass devices=['cpu', ...] to sweep on "
                           "the CPU")
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops import _build

        _build.build_all()
    jobs = {}
    for i, seq in enumerate(scene_paths):
        kwargs = dict(fit_kwargs or {})
        kwargs.setdefault("logs_suffix", f"{seq}_{log_suffix}")
        kwargs.setdefault("common_logs", True)
        jobs.setdefault(i % len(devices), []).append((seq, kwargs))
    threads = max(1, (os.cpu_count() or 1) // len(jobs))
    results = {}
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(_fit_worker, j, devices[d], threads) for d, j in jobs.items()]
        for f in futs:
            results.update(f.result())
    return {str(s): results[str(s)] for s in scene_paths}


def main(path: str, log_suffix: str = "logs", num_points: int = 50000,
         iterations_first: int = 500, iterations_camera: int = 150,
         iterations_after: int = 300, resize: int = 480, device: str = "cuda"):
    """Sweep a benchmark_multi-style dataset root (<root>/<scene>/<scene>)
    over every visible card (device "cuda"), or one CPU worker ("cpu")."""
    folders = sorted(glob.glob(os.path.join(path, "*")))
    scenes = [
        os.path.join(f, os.path.basename(f))
        for f in folders
        if os.path.isdir(os.path.join(f, os.path.basename(f)))
    ]
    if not scenes:
        raise FileNotFoundError(f"no <scene>/<scene> dirs under {path}")
    devices = ["cpu"] if torch.device(device).type == "cpu" else None
    n_dev = 1 if devices else torch.cuda.device_count()
    print_color(f"[sweep] {len(scenes)} scenes over {n_dev} devices")
    return fit_scenes(
        scenes,
        fit_kwargs=dict(
            num_points=num_points, iterations_first=iterations_first,
            camera_first=True, iterations_camera=iterations_camera,
            iterations_after=iterations_after, resize=resize,
            lambda_depth=0.1, lambda_var=50.0, lambda_flow=0.01,
            densify_interval=150, densify_times=2, traj_num=200,
        ),
        devices=devices,
        log_suffix=log_suffix,
    )
