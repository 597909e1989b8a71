"""The prior models' share of the chip's fp32 peak over the traced
sequence: the GMFlow and MASt3R forwards' operations
(``work/prep_flops.py``, from the widths and input shapes) over the traced
sequence's seconds x 67 TFLOP/s (the configuration states float32, TF32
off), in percent."""

PEAK = 67e12


def read(r):
    work, t = r.get("work"), r.get("trace")
    if not work or not t or t["window_s"] <= 0:
        return None
    return 100.0 * work["total"] / (t["window_s"] * PEAK)
