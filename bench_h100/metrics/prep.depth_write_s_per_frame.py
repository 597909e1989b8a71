"""Seconds a frame of the prior preparation spends in prep_depth's files
(the depth maps resized back to the frame's size, ``.npy``, PNG and camera
JSON): the program's phase ``prep_depth/write`` in the process's telemetry
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
    t = current().traced_seconds.get("prep_depth/write")
    return t / frames if t else None
