"""Device milliseconds a frame of the mask prior spends in SAM's image
encoder (the frame's resize, normalization and the ViT, one graph
replay): the program's stamps ``mask/encode`` on the card's timer
(``gflow_tpu_torch/pipeline/prep_mask.py``, ``ops/stamp.py``) in the
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
    t = current().traced_seconds.get("mask/encode")
    return 1e3 * t / frames if t else None
