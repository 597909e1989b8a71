"""SAM 2's image encoder's share of the chip's fp32 peak: its operations a
frame (``work/sam2_work.py``, from the widths and the frame's shapes) over
its stamped device seconds a frame (``track/encode``, as
``track.encode_ms_per_frame`` reads them) x 67 TFLOP/s (the configuration
states float32, TF32 off), in percent. None where the program records no
such stamps."""

PEAK = 67e12


def read(r):
    frames, work = (r.get("traced") or {}).get("frames"), r.get("sam2_work")
    if not frames or not work:
        return None
    try:
        from gflow_tpu_torch.utils.profiling import current
    except ImportError:
        return None
    t = current().traced_seconds.get("track/encode")
    return 100.0 * work["encode_flops"] * frames / (t * PEAK) if t else None
