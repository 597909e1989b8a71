"""The card: its name, power limit and clocks from nvidia-smi, and the
published peaks that every share of a roofline is taken against (NVIDIA's
H100 SXM data sheet, dense rates; at the full 700 W)."""
from __future__ import annotations

import subprocess

PEAK_FP32_FLOPS = 67e12   # float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3

SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def smi() -> list[dict]:
    """One dict per card, or [] when nvidia-smi cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    keys = SMI_FIELDS.split(",")
    return [dict(zip(keys, (v.strip() for v in line.split(","))))
            for line in out.strip().splitlines() if line.strip()]


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the fp32 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
