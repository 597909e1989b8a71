"""Spans the benchmark records from its own files, around the calls into
each layer of the program: wall seconds by name (host clock, after the
call returned), and, while the profiler runs, a ``record_function`` range
of the same name, so that the trace can say what the host did in an idle
gap of the device."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.tracing:
            from torch.profiler import record_function

            rf = record_function("span:" + name)
        t = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1

    def reset(self):
        self.seconds.clear()
        self.calls.clear()
