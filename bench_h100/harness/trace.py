"""The traced window of a ``--trace 1`` run: torch.profiler's CUPTI trace
of the host and the card, reduced to what the per-layer metrics and the
ledger read.

- ``busy_s``: the seconds in which an operation ran on the card (kernels,
  copies, fills): the union of their intervals, so that overlapping
  streams count once;
- ``window_s``: the host clock from the profiler's start to the card's
  last work of the window (a synchronize closes it);
- ``device_ops``: device seconds and calls by kernel name;
- ``idle_gaps``: the seconds in which the card was idle, by what the host
  was doing then: the innermost benchmark span (``span:`` ranges, see
  ``harness.spans``) or program phase (``phase:``) over the gap's middle.

The profiler is started and stopped through its low-level calls where they
exist, so that the events are read without building a Python object per
event; otherwise through ``torch.profiler.profile``.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

GAP_MIN_NS = 5_000  # idle gaps shorter than this are not labelled (still counted)
# the benchmark's own ranges (harness.spans, the drivers' phases): the
# profiler mirrors a record_function range onto the device's timeline as a
# user annotation, which is no device work
ANNOTATIONS = ("span:", "phase:")


def _start():
    import torch
    from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)
    from torch._C._profiler import _ExperimentalConfig

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if _cuda() else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    _sync()
    return _disable_profiler


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _raw_events(result):
    """(device rows, host rows): name, start ns, duration ns."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in result.events():
        row = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not row[0].startswith(ANNOTATIONS):
            dev.append(row)
    return dev, host


class Tracer:
    """``with tracer.window(): ...`` traces that block when enabled; the
    reduction is in ``summary`` afterwards (None when not enabled)."""

    def __init__(self, enabled: bool, spans=None):
        self.enabled = enabled
        self.spans = spans
        self.summary = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        if self.spans is not None:
            self.spans.tracing = True
        prof = None
        try:
            stop = _start()
        except (ImportError, AttributeError, TypeError, RuntimeError):
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if _cuda() else []))
            prof.__enter__()
            stop = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            window_s = time.perf_counter() - t0
            if stop is not None:
                result = stop()
            else:
                prof.__exit__(None, None, None)
                result = prof.profiler.kineto_results
            if self.spans is not None:
                self.spans.tracing = False
        t = time.perf_counter()
        dev, host = _raw_events(result)
        self.summary = reduce(dev, host, window_s)
        self.summary["reduce_s"] = time.perf_counter() - t


def union_ns(starts: np.ndarray, ends: np.ndarray):
    """Merged busy intervals (sorted starts, ends) of possibly overlapping
    intervals."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    seg_s = s[idx]
    seg_e = np.append(reach[idx[1:] - 1], reach[-1])
    return seg_s, seg_e


def reduce(dev_rows, host_rows, window_s: float) -> dict:
    out = {"window_s": window_s, "busy_s": 0.0, "device_ops": [], "idle_gaps": [],
           "kernels": 0}
    if not dev_rows:
        return out
    names = [r[0] for r in dev_rows]
    st = np.fromiter((r[1] for r in dev_rows), np.int64, len(dev_rows))
    du = np.fromiter((r[2] for r in dev_rows), np.int64, len(dev_rows))
    seg_s, seg_e = union_ns(st, st + du)
    out["busy_s"] = float((seg_e - seg_s).sum()) / 1e9
    out["kernels"] = len(dev_rows)
    by = {}
    for n, d in zip(names, du.tolist()):
        a = by.setdefault(n, [0, 0])
        a[0] += d
        a[1] += 1
    ops = sorted(by.items(), key=lambda kv: -kv[1][0])
    out["device_ops"] = [[n, v[0] / 1e9, v[1]] for n, v in ops]
    # idle gaps inside the window: before the first device op, between
    # busy segments, after the last (the window's host bounds, taken as the
    # first and last host event)
    h_st = np.fromiter((r[1] for r in host_rows), np.int64, len(host_rows))
    h_du = np.fromiter((r[2] for r in host_rows), np.int64, len(host_rows))
    lo = int(min(seg_s[0], h_st.min())) if len(h_st) else int(seg_s[0])
    hi = max(int(seg_e[-1]), lo + int(window_s * 1e9))
    gap_s = np.concatenate([[lo], seg_e])
    gap_e = np.concatenate([seg_s, [hi]])
    keep = gap_e - gap_s >= GAP_MIN_NS
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    labelled = [i for i, r in enumerate(host_rows) if r[0].startswith(("span:", "phase:"))]
    lab_names = [host_rows[i][0] for i in labelled]
    ls = h_st[labelled] if labelled else np.zeros(0, np.int64)
    le = ls + (h_du[labelled] if labelled else 0)
    idle = {}
    mids = (gap_s + gap_e) // 2
    for a, b, m in zip(gap_s.tolist(), gap_e.tolist(), mids.tolist()):
        cover = np.flatnonzero((ls <= m) & (le >= m))
        label = "outside spans"
        if len(cover):
            label = lab_names[cover[np.argmin((le - ls)[cover])]]
        idle[label] = idle.get(label, 0) + (b - a)
    out["idle_gaps"] = [[k, v / 1e9] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]
    return out


def breakdown(summary: dict, n: int = 10) -> dict:
    """The result line's ``breakdown``: the n device operations that took
    most time and the n largest idle totals by host activity."""
    return {"device_ops": [[k[:120], s] for k, s, _ in summary["device_ops"][:n]],
            "idle_gaps": [[k[:120], s] for k, s in summary["idle_gaps"][:n]]}
