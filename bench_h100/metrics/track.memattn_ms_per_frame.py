"""Device milliseconds a frame of the video mask prior spends in
SAM 2's memory attention (the memory-conditioned features of every object over the bank: one graph replay; none on the prompted frame 0): the program's stamps ``track/memattn`` on the card's timer
(``gflow_tpu_torch/pipeline/prep_track.py``, ``ops/stamp.py``) in the
process's telemetry, the part recorded under the profiler (the traced
sequence), over that sequence's frames. None where the program records no
such stamps."""


def read(r):
    frames = (r.get("traced") or {}).get("frames")
    if not frames:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds.get("track/memattn")
    return 1e3 * t / frames if t else None
