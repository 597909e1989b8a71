"""Seconds a frame of the prior preparation spends in the global
alignment's host work (its NumPy set-up before the refinement and the
outputs after it): the program's phase ``prep_depth/align_host`` in the
process's telemetry (``gflow_tpu_torch.utils.profiling.current()``), the
part that ran under the profiler (``traced_seconds``: the traced sequence),
over that sequence's frames. None where the program records no such
phase."""


def read(r):
    frames = (r.get("traced") or {}).get("frames")
    if not frames:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds.get("prep_depth/align_host")
    return t / frames if t else None
