"""Tracing and telemetry.

Counterpart of ``gflow_tpu/utils/profiling.py``:

- `Telemetry.phase(name)`: context manager accumulating wall-clock per
  pipeline phase; `Telemetry` also counts frames and optimizer steps
  (s/frame, steps/s) and dumps everything as JSON;
- `trace(logdir)`: a torch.profiler capture of CPU and CUDA activity,
  written as a Chrome trace (``logdir/trace.json``).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


def _median(xs):
    if not xs:
        return 0.0
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class Telemetry:
    def __init__(self):
        self.phase_seconds = defaultdict(float)
        self.phase_calls = defaultdict(int)
        self.phase_first = {}   # first-call duration: the first call carries
        self.phase_max = {}     # the one-time costs (kernel builds, first
                                # allocations), so (first, max, rest-mean)
                                # separates them from the steady state
        self.phase_durations = defaultdict(list)  # per-call, for the median
        self.frames = 0
        self.opt_steps = 0
        self.gauges = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            dt = time.time() - t
            self.phase_seconds[name] += dt
            self.phase_calls[name] += 1
            self.phase_first.setdefault(name, dt)
            self.phase_max[name] = max(self.phase_max.get(name, 0.0), dt)
            self.phase_durations[name].append(dt)

    def count_frame(self, opt_steps: int):
        self.frames += 1
        self.opt_steps += opt_steps

    def gauge(self, name: str, value):
        """Record a point-in-time observable (e.g. tile-truncation rate)."""
        self.gauges[name] = value

    def summary(self) -> dict:
        total = time.time() - self._t0
        out = {
            "total_sec": round(total, 3),
            "frames": self.frames,
            "sec_per_frame": round(total / max(self.frames, 1), 3),
            "opt_steps_per_sec": round(self.opt_steps / max(total, 1e-9), 2),
            "phases": {
                k: {
                    "sec": round(v, 3),
                    "calls": self.phase_calls[k],
                    # the first call pays the one-time costs;
                    # steady_sec_per_call is the rate after it
                    "first_sec": round(self.phase_first[k], 3),
                    # max_sec exposes mid-run outliers that would
                    # otherwise hide in the average
                    "max_sec": round(self.phase_max[k], 3),
                    # mean over everything after the first call: mid-run
                    # outliers land in this mean, the median is the
                    # steady rate
                    "steady_sec_per_call": round(
                        (v - self.phase_first[k])
                        / max(self.phase_calls[k] - 1, 1), 3),
                    "median_sec_per_call": round(
                        _median(self.phase_durations[k]), 3),
                }
                for k, v in sorted(self.phase_seconds.items())
            },
        }
        out.update(self.gauges)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (host and, where there is a card,
    device timeline) into `logdir`/trace.json (chrome://tracing)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
