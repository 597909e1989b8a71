"""Where the kernel-vs-plain loss gap of a stage comes from, on the GPU.

    python3 scripts/torch_stage_spread.py [--lengths 10,20,100,300] [--cpu-seconds 900]

On chip_smoke.py's scene (854x480, 50,000 points, its check targets and
full-stage dynamics, no densify), under chip_smoke.deterministic(), runs a
full stage of each length eagerly (opt.graphs.disable_graphs: a replay
gives the same numbers) through

- the kernels;
- the plain versions of all of them ("all": chip_smoke.plain_versions());
- the plain version of one kernel at a time, the others kernels ("fwd":
  K1/K2, cuda_raster.packed_composite's forward; "bwd": K3, its backward;
  "tail": K4, binning.bin_tail);
- the plain versions on the CPU ("cpu", against "all" on the card): no
  kernel in either, so this pair measures float32 rounding amplified by
  Adam, the yardstick of the others. The CPU runs only the lengths whose
  estimated time (from a 1-iteration stage) fits --cpu-seconds.

Prints, per pair and length, the relative gap of the final loss and the
largest relative gap over the trace, and one JSON line with all of them.
"""
import argparse
import json
import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
warnings.filterwarnings("ignore")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SWAPS = {"all": cs.PLAIN_PARTS, "fwd": ("fwd",), "bwd": ("bwd",), "tail": ("tail",)}


def stage_trace(scene, iters, device="cuda", parts=None):
    """chip_smoke.lean_stage_trace, eager (a replay gives the same
    numbers) and deterministic."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    with cs.deterministic(), stage_graphs.disable_graphs():
        return cs.lean_stage_trace(scene, iters, device, parts)


def gaps(a, b):
    rel = (a - b).abs() / b.abs()
    return {"final": float(rel[-1]), "max": float(rel.max())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="10,20,100,300")
    ap.add_argument("--cpu-seconds", type=float, default=900.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.set_num_threads(os.cpu_count())
    scene = cs.bench_scene()
    lengths = [int(x) for x in args.lengths.split(",")]
    out = {"card": smi, "cpu_threads": torch.get_num_threads(), "pairs": {}, "cpu_lengths": []}
    t0 = time.perf_counter()
    stage_trace(scene, 1, "cpu")
    cpu_s_per_iter = time.perf_counter() - t0
    budget = args.cpu_seconds
    for L in lengths:
        t_len = time.perf_counter()
        kern = stage_trace(scene, L)
        runs = {name: stage_trace(scene, L, parts=parts) for name, parts in SWAPS.items()}
        for name, tr in runs.items():
            out["pairs"].setdefault(name, {})[L] = gaps(kern, tr)
        # the CPU stage pays a final forward too: ~ (L + 1) iterations
        if (L + 1) * cpu_s_per_iter / 2 <= budget:
            t0 = time.perf_counter()
            cpu = stage_trace(scene, L, "cpu")
            budget -= time.perf_counter() - t0
            out["pairs"].setdefault("cpu", {})[L] = gaps(runs["all"], cpu)
            out["cpu_lengths"].append(L)
        row = {name: out["pairs"][name].get(L) for name in out["pairs"]}
        print(f"# length {L} ({time.perf_counter() - t_len:.0f} s): {json.dumps(row)}", flush=True)
    out["cpu_s_per_iter_estimate"] = cpu_s_per_iter / 2
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
