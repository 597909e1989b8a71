"""How late time.sleep(0.001) wakes on this host, and how often that fails
tests/test_profiling.py::test_phase_stats_separate_compile_from_steady.

That test times five Telemetry phases that sleep 50, 1, 40, 1 and 1 ms
and asserts that their median, rounded to the millisecond, is below
10 ms. The median of the five is the largest of the three 1-ms calls, so
ONE of them waking ~8.5 ms late fails the test. This script repeats the
test's pattern for a while and prints the failure rate and the
distribution of the 1-ms sleeps' overshoot.

    python3 scripts/probe_sleep_overshoot.py --seconds 90

Run it alone, and again beside a CPU load (for example five processes of
``python -m pytest tests/test_torch_train.py``, with and without
OMP_NUM_THREADS=1), to see whether the load moves the rate.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gflow_tpu.utils.profiling import Telemetry  # noqa: E402


def main(seconds: float):
    over, fails, trials = [], 0, 0
    t_end = time.time() + seconds
    while time.time() < t_end:
        tel = Telemetry()
        for dt in (0.05, 0.001, 0.04, 0.001, 0.001):
            t0 = time.perf_counter()
            with tel.phase("stage"):
                time.sleep(dt)
            if dt == 0.001:
                over.append(time.perf_counter() - t0 - dt)
        trials += 1
        fails += tel.summary()["phases"]["stage"]["median_sec_per_call"] >= 0.01
    o = np.asarray(over) * 1e3
    print(f"trials {trials} failures {fails} ({fails / trials:.4f}); 1-ms sleep overshoot ms: "
          f"p50 {np.percentile(o, 50):.3f} p99 {np.percentile(o, 99):.3f} max {o.max():.3f}; "
          f"share above 8.5 ms {(o > 8.5).mean():.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    main(ap.parse_args().seconds)
