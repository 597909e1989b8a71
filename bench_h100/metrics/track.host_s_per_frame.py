"""Seconds a frame of the video mask prior spends in its host pieces: the
program's phases ``prep_track/load`` (the frame read and sent to the card)
and ``prep_track/write`` (after the frame's device work, the union read
back and the PNG) in the process's telemetry, the part that ran under the
profiler (the traced sequence), over that sequence's frames. None where
the program records no such phases."""

PHASES = ("prep_track/load", "prep_track/write")


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
