"""Times GMFlow's refinement convolutions on the card in fp32 (TF32 off) by
the route that computes them.

    python3 scripts/torch_conv_algos.py

GMFlow's motion encoder convolves a (1, 256, 120, 216) correlation map at
864x480 with 3x3 kernels to 192 and 126 channels, six times a directed
pair. For each shape: cuDNN with its heuristic (NCHW and channels-last),
cuDNN's autotuner, ATen's im2col + GEMM (cuDNN off), and F.unfold + one
matmul; the median ms of 10 calls after 3 warm-ups, each route's max abs
difference from the CPU's F.conv2d, and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gflow_tpu_torch.models.precision import fp32_math  # noqa: E402


def ms(fn, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[reps // 2]


def unfold_conv(x, w, b):
    B, C, H, W = x.shape
    cols = F.unfold(x, w.shape[2:], padding=(w.shape[2] // 2, w.shape[3] // 2))
    return (w.reshape(w.shape[0], -1) @ cols + b[:, None]).reshape(B, -1, H, W)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator().manual_seed(0)
    for cout in (192, 126):
        x = torch.randn(1, 256, 120, 216, generator=g)
        w = torch.randn(cout, 256, 3, 3, generator=g) / 48
        b = torch.randn(cout, generator=g) / 48
        want = F.conv2d(x, w, b, padding=1)
        xc, wc, bc = x.cuda(), w.cuda(), b.cuda()
        xl = xc.to(memory_format=torch.channels_last)
        cudnn = torch.backends.cudnn
        routes = {
            "cudnn_nchw": lambda: F.conv2d(xc, wc, bc, padding=1),
            "cudnn_channels_last": lambda: F.conv2d(xl, wc.to(memory_format=torch.channels_last),
                                                    bc, padding=1),
            "aten_im2col_gemm": lambda: _without_cudnn(lambda: F.conv2d(xc, wc, bc, padding=1)),
            "unfold_matmul": lambda: unfold_conv(xc, wc, bc),
        }
        row = {"shape": [list(x.shape), list(w.shape)]}
        with fp32_math():
            for name, fn in routes.items():
                row[name] = {"ms": ms(fn), "max_abs_err": float((fn().cpu() - want).abs().max())}
            cudnn.benchmark = True
            row["cudnn_autotuned"] = {"ms": ms(routes["cudnn_nchw"]), "max_abs_err": float(
                (routes["cudnn_nchw"]().cpu() - want).abs().max())}
            cudnn.benchmark = False
        print(json.dumps(row), flush=True)


def _without_cudnn(fn):
    with torch.backends.cudnn.flags(enabled=False):
        return fn()


if __name__ == "__main__":
    main()
