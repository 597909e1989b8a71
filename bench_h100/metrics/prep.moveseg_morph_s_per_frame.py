"""Seconds a frame of the prior preparation spends in prep_moveseg's
morphology (the threshold and SciPy's opening, erosion and dilation): the
program's phase ``prep_moveseg/morph`` in the process's telemetry
(``gflow_tpu_torch.utils.profiling.current()``), the part that ran under
the profiler (``traced_seconds``: the traced sequence), over that
sequence's frames. None where the program records no such phase."""


def read(r):
    frames = (r.get("traced") or {}).get("frames")
    if not frames:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds.get("prep_moveseg/morph")
    return t / frames if t else None
