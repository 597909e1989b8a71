"""The decode and post-processing's share of their roofline: the least
time of a frame's grid batches on the published peaks, each part's larger
of operations / 67 TFLOP/s and bytes / 3.35 TB/s (``work/sam_work.py``:
the decode's operations and bytes, the post-processing's bytes), over
their stamped device seconds a frame (``mask/decode`` + ``mask/post``), in
percent. None where the program records no such stamps."""

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def read(r):
    frames, work = (r.get("traced") or {}).get("frames"), r.get("sam_work")
    if not frames or not work:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds
    spent = t.get("mask/decode", 0.0) + t.get("mask/post", 0.0)
    if not spent:
        return None
    least = (max(work["decode_flops"] / PEAK_FLOPS, work["decode_bytes"] / PEAK_BYTES)
             + work["post_bytes"] / PEAK_BYTES)
    return 100.0 * least / (spent / frames)
