"""Device milliseconds a frame of the mask prior spends taking every
batch's mask logits to the frame's size and through the stability and
binarize pass: the program's stamps ``mask/post`` on the card's timer
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
    t = current().traced_seconds.get("mask/post")
    return 1e3 * t / frames if t else None
