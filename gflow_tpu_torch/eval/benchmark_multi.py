"""Dataset-level benchmark sweep (reference: gflow/benchmark_multi.py):
iterate scene folders, locate each <seq>_<log_suffix>/0_latest/<ts> run,
evaluate, aggregate per-metric averages over valid values into metrics.csv.

Counterpart of ``gflow_tpu/eval/benchmark_multi.py``, with ``device``
passed on to each scene's benchmark. The average of a column skips values
that are not numbers (the ``LPIPS_note`` text that a run without LPIPS
weights adds), where the JAX package's sum raises on them.
"""
from __future__ import annotations

import glob
import numbers
import os

from .. import resolve_device
from .benchmark import main as benchmark_main


def main(path: str, log_suffix: str = "logs_cam_init_only", device: str | None = None):
    dev = resolve_device(device)
    folders = sorted(glob.glob(os.path.join(path, "*")))
    results = {}
    for folder in folders:
        name = os.path.basename(folder)
        sequence_path = os.path.join(folder, name)
        latest = os.path.join(folder, f"{name}_{log_suffix}", "0_latest")
        if not os.path.exists(latest):
            continue
        subs = [p for p in glob.glob(os.path.join(latest, "*")) if os.path.isdir(p)]
        if not subs:
            continue
        print(f"Evaluating {name}...")
        results[name] = benchmark_main(
            log_path=subs[0], sequence_path=sequence_path, csv_name=log_suffix, device=dev
        )

    if not results:
        print("no sequences evaluated")
        return {}

    headers = list(next(iter(results.values())).keys())
    sums = {h: 0.0 for h in headers}
    counts = {h: 0 for h in headers}
    csv_path = os.path.join(path, "metrics.csv")
    with open(csv_path, "w") as f:
        f.write("sequence," + ",".join(headers) + "\n")
        for name, row in results.items():
            f.write(name)
            for h in headers:
                v = row.get(h)
                f.write(f",{v}")
                if isinstance(v, numbers.Real):
                    sums[h] += v
                    counts[h] += 1
            f.write("\n")
        f.write("Average")
        for h in headers:
            avg = sums[h] / counts[h] if counts[h] else None
            f.write(f",{avg}")
        f.write("\n")
    print(f"Metrics saved in {csv_path}")
    return results
