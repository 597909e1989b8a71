"""Tracing and telemetry: the port's one recorder of program spans and
counters.

Counterpart of ``gflow_tpu/utils/profiling.py``:

- `Telemetry.phase(name)`: a context manager that times a phase of the
  program under its name. A phase opened inside another is recorded under
  its own name, with the other as its parent (``phase_parent``), and its
  seconds count as the parent's children (``self_seconds``: a phase less
  its children). `Telemetry.add(name, seconds, calls)` records a duration
  measured elsewhere, on the card or on another thread; it has no parent.
  `Telemetry` also counts frames and optimizer steps (s/frame, steps/s),
  named counts (`count(name, n)`: how many items a stage handled, such as
  the mask prior's prompts and the masks each filter kept) and gauges,
  and dumps everything as JSON. A Telemetry's phases are opened
  from one thread.
- `current()`: the process-wide Telemetry, which program code outside a
  trainer records into (the prior preparation's stages).
- `trace(logdir)`: a torch.profiler capture of CPU and CUDA activity,
  written as a Chrome trace (``logdir/trace.json``).

The clock. torch.profiler stamps its host events in nanoseconds of the
Unix epoch (``CLOCK_REALTIME``, what ``time.time_ns()`` reads; the profiler
converts its cycle counter to it). Phases are timed with
``time.time_ns()`` too, so a phase's seconds and its range in a trace are
read off one clock.

Under the profiler. While torch.profiler records, each phase also opens
``torch.profiler.record_function("phase:" + name)``, so that the trace's
own timeline holds the program's phases, and adds its seconds to
``traced_seconds`` too: the part of each phase that a trace covers. The
check reads the profiler's C++ state as well as
``torch.autograd.profiler._is_profiler_enabled``: a profiler started
through its low-level calls leaves that Python flag unset. With the
profiler off a phase reads the clock twice and updates its sums: no range
is made and no record is kept per call but its duration (for the median).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "phase:"  # the profiler ranges' prefix, which a trace's reader drops
                   # from the device's rows (a user annotation is no device work)


def profiler_on() -> bool:
    """Whether torch.profiler is recording in this process."""
    return _autograd_profiler._is_profiler_enabled or torch.autograd._profiler_enabled()


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
        self.phase_durations = defaultdict(list)  # per call, for the median
        self.phase_parent = {}                    # name -> the phase it last ran inside
        self.child_seconds = defaultdict(float)   # name -> seconds of the phases inside it
        self.traced_seconds = defaultdict(float)  # the part that ran under the profiler
        self.frames = 0
        self.opt_steps = 0
        self.gauges = {}
        self.counters = defaultdict(int)
        self._open = []  # the open phases' names, innermost last
        self._t0 = time.time_ns()

    @contextlib.contextmanager
    def phase(self, name: str):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        traced = profiler_on()
        if traced:  # the range's stamps fall inside [t0, t1]
            rf = torch.profiler.record_function(PREFIX + name)
            t0 = time.time_ns()
            rf.__enter__()
        else:
            t0 = time.time_ns()
        try:
            yield
        finally:
            if traced:
                rf.__exit__(None, None, None)
            t1 = time.time_ns()
            self._open.pop()
            dt = (t1 - t0) * 1e-9
            self.phase_seconds[name] += dt
            self.phase_calls[name] += 1
            self.phase_durations[name].append(dt)
            self.phase_parent[name] = parent
            if parent is not None:
                self.child_seconds[parent] += dt
            if traced:
                self.traced_seconds[name] += dt

    def add(self, name: str, seconds: float, calls: int = 1):
        """Record `calls` calls of `name` that took `seconds` in all,
        measured elsewhere (device stamps, another thread's clock); their
        mean counts once toward the median."""
        self.phase_seconds[name] += seconds
        self.phase_calls[name] += calls
        self.phase_durations[name].append(seconds / max(calls, 1))
        if profiler_on():
            self.traced_seconds[name] += seconds

    def self_seconds(self) -> dict:
        """Each phase's seconds less those of the phases opened inside it."""
        return {k: v - self.child_seconds.get(k, 0.0) for k, v in self.phase_seconds.items()}

    def count_frame(self, opt_steps: int):
        self.frames += 1
        self.opt_steps += opt_steps

    def count(self, name: str, n: int = 1):
        """Add n to the counter `name`."""
        self.counters[name] += int(n)

    def gauge(self, name: str, value):
        """Record a point-in-time observable (e.g. tile-truncation rate)."""
        self.gauges[name] = value

    def summary(self) -> dict:
        total = (time.time_ns() - self._t0) * 1e-9
        own = self.self_seconds()
        out = {
            "total_sec": round(total, 3),
            "frames": self.frames,
            "sec_per_frame": round(total / max(self.frames, 1), 3),
            "opt_steps_per_sec": round(self.opt_steps / max(total, 1e-9), 2),
            "phases": {
                k: {
                    "sec": round(v, 3),
                    "calls": self.phase_calls[k],
                    "median_sec_per_call": round(_median(self.phase_durations[k]), 3),
                    "self_sec": round(own[k], 3),
                    "parent": self.phase_parent.get(k),
                }
                for k, v in sorted(self.phase_seconds.items())
            },
        }
        if self.counters:
            out["counters"] = dict(sorted(self.counters.items()))
        out.update(self.gauges)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


_current: Telemetry | None = None


def current() -> Telemetry:
    """The process-wide Telemetry, made at the first call."""
    global _current
    if _current is None:
        _current = Telemetry()
    return _current


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (host and, where there is a card,
    device timeline) into `logdir`/trace.json (chrome://tracing)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
