"""Time two builds of small_eig (the LMedS's smallest-eigenvector kernel,
gflow_tpu_torch/csrc/small_eig.cu) on the same card, in one process, in
turns: baseline, change, change, baseline.

    python3 scripts/torch_small_eig_ab.py --baseline _parent

`--baseline` is the root of another checkout of the repo (for instance the
parent commit unpacked with `git archive` into a git-ignored directory);
its small_eig.cu is built with the same nvcc flags as this checkout's, and
both are called through the C entry point gflow_small_eig on the same
inputs. This checkout's source is also built with
-DGFLOW_SMALL_EIG_WARP_MIN_N=1 ("change, warp at every n"), so the rows of
n < 5, where the change keeps one thread per matrix, time the warp layout
too. Rows: synthetic 9x9 x 512 and 3x3 x 512 of separated spectra
(chip_smoke.separated_symmetric), and the LMedS's own four eigenproblems
on the rigid scene's 854x480 flow (chip_smoke.lmeds_eig_inputs: 9x9 and
3x3 x 512, the refit's 9x9 and 3x3 x 1). Each build must meet
chip_smoke.py's bounds on each row: residual |A v - l v| / |A| <= 1e-5,
and on the synthetic rows |v . v_eigh| >= 1 - 1e-5. Times are device ms
per launch (CUDA-graph replays, chip_smoke.kernel_ms) beside
torch.linalg.eigh's (eager, chip_smoke.cuda_ms), with each build's
registers and shared memory for that n (ptxas -v); one JSON line per row
with the card's name and power limit, all rows to
chiprun_out/small_eig_ab.json.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from torch_ab import ROOT, TURNS, build, c_function, card, write_rows

import chip_smoke as cs  # noqa: E402  (torch_ab put the root on sys.path)
from gflow_tpu_torch.ops import _build  # noqa: E402

WARP_ALL = "change, warp at every n"


def check(v, A, separated):
    """Residual and (on separated spectra) dot against eigh; raises past
    chip_smoke.py's bounds."""
    lam = torch.einsum("bi,bij,bj->b", v, A, v)
    res = float((torch.linalg.vector_norm(A @ v[..., None] - lam[:, None, None] * v[..., None],
                                          dim=(1, 2)) / torch.linalg.matrix_norm(A)).max())
    dot = float((v * torch.linalg.eigh(A)[1][..., :, 0]).sum(-1).abs().min())
    assert res <= cs.SMALL_EIG_RES and (not separated or dot >= 1 - cs.SMALL_EIG_DOT), (res, dot)
    return {"residual": res, "min_abs_dot": dot}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout whose small_eig.cu is the baseline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_small_eig_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    argtypes = _build.KERNELS["small_eig"][1:]
    builds = {"baseline": (args.baseline, "baseline", ()), "change": (ROOT, "change", ()),
              WARP_ALL: (ROOT, "change-warp", ("-DGFLOW_SMALL_EIG_WARP_MIN_N=1",))}
    libs, ptxas = {}, {}
    for tag, (checkout, name, extra) in builds.items():
        libs[tag] = c_function(build(checkout, "small_eig.cu", name, extra), *argtypes)
        ptxas[tag] = cs.small_eig_ptxas(_build.BUILD_LOGS[f"small_eig-{name}"])
    print(f"# three nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    inputs = {"synthetic 9x9": cs.separated_symmetric(9, 512),
              "synthetic 3x3": cs.separated_symmetric(3, 512, seed=1),
              **cs.lmeds_eig_inputs()}
    rows = []
    for where, A in inputs.items():
        batch, n = A.shape[0], A.shape[-1]
        outs = {tag: torch.empty((batch, n), device="cuda") for tag in libs}
        run = {tag: (lambda tag=tag: libs[tag](A, outs[tag], batch, n)) for tag in libs}
        checks = {}
        for tag in libs:
            run[tag]()
            torch.cuda.synchronize()
            checks[tag] = check(outs[tag], A, where.startswith("synthetic"))
        times = {}
        for tag in (*TURNS, WARP_ALL, WARP_ALL):
            times.setdefault(tag, []).append(cs.kernel_ms(run[tag]))
        rows.append({"input": where, "batch": batch, "n": n,
                     "baseline_ms": times["baseline"], "change_ms": times["change"],
                     "warp_at_every_n_ms": times[WARP_ALL],
                     "eigh_ms": cs.cuda_ms(lambda: torch.linalg.eigh(A)),
                     "checks": checks, "ptxas": {tag: p.get(n) for tag, p in ptxas.items()}})
    write_rows("small_eig_ab", smi, rows)


if __name__ == "__main__":
    main()
