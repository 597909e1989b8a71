"""Counters read from the program: CUDA-graph captures (a counter wrapped
around the port's ``opt.graphs.CapturedGraph``), so that a run can say
whether anything was recorded inside its window."""
from __future__ import annotations


def count_captures():
    """A function that returns the captures made since this call."""
    from gflow_tpu_torch.opt import graphs

    n = [0]
    orig = graphs.CapturedGraph.__init__

    def counted(self, *args, **kw):
        n[0] += 1
        orig(self, *args, **kw)

    graphs.CapturedGraph.__init__ = counted
    return lambda: n[0]
