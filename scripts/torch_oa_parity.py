"""Both packages' eval_tracking on the same hand-written 854x480 checkpoints.

    python3 scripts/torch_oa_parity.py [--points 53600] [--frames 3]

chip_smoke.py's eval scores OA 47-50 on its 854x480 fit, where the CPU's
96x64 runs score 85-86. This script asks whether the port's tracking
suite differs from the JAX package's at that size: it writes
tests/synth.py's moving-camera sequence at 854x480 (with tracking.pkl)
and `--frames` checkpoints of seeded Gaussians with distinct depths (the
recipe of tests/test_torch_benchmark.py's write_run, scaled), then runs
gflow_tpu.eval.benchmark.eval_tracking (JAX on the CPU, the Pallas
compositor in interpret mode) and gflow_tpu_torch.eval.benchmark.
eval_tracking (device="cpu") on them, and prints both (OA, AJ, APTS) and
the seconds each took.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

W, H, FOCAL = 854, 480, 712.0


def write_checkpoints(run_dir, n, frames, seed=0):
    """tests/test_torch_benchmark.py's write_run at W x H: depths evenly
    spaced in [1.6, 2.4) and shuffled (no ties), a third of the points
    moving 0.01 a frame in x, a camera translating with jitter."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(run_dir, "ckpt"))
    z = (1.6 + 0.8 * rng.permutation(n) / n).astype(np.float32)
    u, v = rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)
    xyz0 = np.c_[(u - W / 2) * z / FOCAL, (v - H / 2) * z / FOCAL, z].astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    params = dict(scale=f32(rng.uniform(0.002, 0.006, (n, 3))),
                  rotate=f32(rng.normal(size=(n, 4))),
                  opacity=f32(rng.uniform(0.5, 3.0, (n, 1))),
                  rgb=f32(rng.normal(0, 1.5, (n, 3))))
    for t in range(frames):
        extr = f32(np.c_[np.eye(3), [0.02 * t, 0.008 * t, 0.0] + rng.normal(0, 0.004, 3)])
        xyz = xyz0 + f32([0.01 * t, 0.0, 0.0]) * (np.arange(n) % 3 == 0)[:, None]
        np.savez(os.path.join(run_dir, "ckpt", f"{t:05d}.npz"), xyz=xyz, **params,
                 intr=f32([FOCAL, FOCAL, W / 2, H / 2]), extr=extr,
                 still_mask=rng.uniform(size=n) < 0.7, last_uv=f32(rng.uniform(0, W, (n, 2))),
                 move_seg=np.zeros(0), width=W, height=H)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=53_600)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gflow_tpu.eval import benchmark as jax_bench
    from gflow_tpu_torch.eval import benchmark as port_bench
    from tests.synth import make_sequence

    with tempfile.TemporaryDirectory() as root:
        seq = make_sequence(root, n_frames=args.frames + 1, W=W, H=H, moving_camera=True)
        run = os.path.join(root, "run")
        write_checkpoints(run, args.points, args.frames)
        out = {"points": args.points, "frames": args.frames, "W": W, "H": H}
        for name, fn in (("jax", lambda: jax_bench.eval_tracking(seq, run)),
                         ("port", lambda: port_bench.eval_tracking(seq, run, device="cpu"))):
            t0 = time.perf_counter()
            oa, aj, apts = fn()
            out[name] = {"OA": float(oa), "AJ": float(aj), "APTS": float(apts),
                         "seconds": time.perf_counter() - t0}
    out["equal"] = all(out["jax"][k] == out["port"][k] for k in ("OA", "AJ", "APTS"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
