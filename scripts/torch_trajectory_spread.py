"""Run-to-run spread of chip_smoke.py's loss-trajectory check on the GPU.

    python3 scripts/torch_trajectory_spread.py

Runs chip_smoke's 3-stage check (camera, full with densify, next frame's
camera; 10 iterations each at 854x480 / 50k points) three times on the
kernels and three times on the plain versions, first with PyTorch's default
algorithms (index_add_ with float atomics) and then with deterministic
ones, and prints the largest relative loss difference per stage for kernel
against plain, kernel against kernel and plain against plain.
"""
import os
import sys
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
warnings.filterwarnings("ignore")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def rel(a, b):
    return [float(((x - y).abs() / y.abs()).max()) for x, y in zip(a, b)]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    scene = cs.bench_scene()
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        runs = []
        for rep in range(3):
            k = cs.check_run(scene)[0]
            with cs.plain_versions():
                p = cs.check_run(scene)[0]
            runs.append((k, p))
            print(f"det={det} rep={rep} kernel-vs-plain {rel(k, p)}", flush=True)
        print(f"det={det} kernel-vs-kernel {rel(runs[0][0], runs[1][0])} "
              f"plain-vs-plain {rel(runs[0][1], runs[1][1])}", flush=True)


if __name__ == "__main__":
    main()
