"""Seconds a frame of the mask prior spends in its host pieces: the
program's phases ``prep_mask/load`` (the frame and its moving-object mask
read and sent to the card), ``prep_mask/select`` (the kept masks
gathered, NMS and the union, after the frame's device work) and
``prep_mask/write`` (the PNG) in the process's telemetry, the part that
ran under the profiler (the traced sequence), over that sequence's
frames. None where the program records no such phases."""

PHASES = ("prep_mask/load", "prep_mask/select", "prep_mask/write")


def read(r):
    frames = (r.get("traced") or {}).get("frames")
    if not frames:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds
    if not any(p in t for p in PHASES):
        return None
    return sum(t.get(p, 0.0) for p in PHASES) / frames
