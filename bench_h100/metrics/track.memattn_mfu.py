"""SAM 2's memory attention's share of the chip's fp32 peak: the operations
of the traced sequence's tracked frames, each at its bank's fill
(``work/sam2_work.py``, from the widths and the shapes), over their
stamped device seconds (``track/memattn``) x 67 TFLOP/s (float32, TF32
off), in percent. None where the program records no such stamps."""

PEAK = 67e12


def read(r):
    traced, work = r.get("traced") or {}, r.get("sam2_work")
    if not traced.get("sequences") or not work:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds.get("track/memattn")
    return 100.0 * work["memattn_flops"] * traced["sequences"] / (t * PEAK) if t else None
