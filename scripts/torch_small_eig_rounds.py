"""Where a round of small_eig's warp layout spends its cycles, on the card.

    python3 scripts/torch_small_eig_rounds.py

Builds two instrumented copies of gflow_tpu_torch/csrc/small_eig.cu (the
source is edited as text, so the kernel is this checkout's): clock64()
around each round's two phases, the angle phase (each lane's pair angle,
published for its index, up to the first __syncwarp) and the update phase
(the block rotation of A and V, up to the second), and the sweeps a matrix
took. "ieee" keeps the kernel's arithmetic; "approx" replaces the angle's
IEEE divisions and reciprocal square root by __fdividef and rsqrtf, which
says what IEEE rounding costs in a round (its results are not the
kernel's). Inputs: chip_smoke.py's synthetic 512 matrices of 9 x 9 and the
LMedS's own 9 x 9 (512 and the refit's 1). One JSON line per input and
build: device ms a launch (chip_smoke.kernel_ms), mean and max sweeps,
cycles a round in each phase (mean over matrices), the slowest matrix's
cycles, the largest residual; the card's name and power limit first; all
rows to chiprun_out/small_eig_rounds.json.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from torch_ab import ROOT, card

import chip_smoke as cs  # noqa: E402  (torch_ab put the root on sys.path)
from gflow_tpu_torch.ops import _build  # noqa: E402


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"small_eig.cu no longer holds {old!r}: update this script")
    return text.replace(old, new, 1)


def instrumented(src: str) -> str:
    """The warp kernel with the clock64 split written to g_stats[b * 4 +
    (sweeps, angle cycles, update cycles, total cycles)]."""
    head, tail = src.split("small_eig_warp_kernel(const float* __restrict__ mats", 1)
    tail = "small_eig_warp_kernel(const float* __restrict__ mats" + tail
    tail = edit(tail, "int batch) {",
                "int batch) {\n  long long c_ang = 0, c_upd = 0, c_all = clock64();\n"
                "  int sweeps = 0;")
    tail = edit(tail, "for (int r = 0; r < M - 1; ++r) {",
                "for (int r = 0; r < M - 1; ++r) {\n      long long c0 = clock64();")
    tail = edit(tail, "__syncwarp();\n      float* B",
                "__syncwarp();\n      long long c1 = clock64();\n      c_ang += c1 - c0;\n"
                "      float* B")
    tail = edit(tail, "__syncwarp();\n      cur ^= 1;",
                "__syncwarp();\n      c_upd += clock64() - c1;\n      cur ^= 1;")
    tail = edit(tail, "if (!__any_sync(0xffffffffu, unconverged)) break;",
                "if (!__any_sync(0xffffffffu, unconverged)) break;\n    sweeps = sweep + 1;")
    tail = edit(tail, "if (lane < N) out[(size_t)b * N + lane]",
                "if (lane == 0) {\n    g_stats[b * 4] = sweeps;\n"
                "    g_stats[b * 4 + 1] = c_ang;\n    g_stats[b * 4 + 2] = c_upd;\n"
                "    g_stats[b * 4 + 3] = clock64() - c_all;\n  }\n"
                "  if (lane < N) out[(size_t)b * N + lane]")
    text = edit(head + tail, "namespace {", "namespace {\n__device__ long long* g_stats;")
    return text + ('\nextern "C" int gflow_small_eig_stats(long long* p) {\n'
                   "  return (int)cudaMemcpyToSymbol(g_stats, &p, sizeof(p));\n}\n")


def approx(src: str) -> str:
    """The angle with __fdividef and rsqrtf in place of IEEE division and
    1 / sqrtf."""
    text = edit(src, "0.5f * (aqq - app) / (skip ? 1.0f : apq)",
                "__fdividef(0.5f * (aqq - app), skip ? 1.0f : apq)")
    root = "fabsf(theta) + sqrtf(fmaf(theta, theta, 1.0f))"
    text = edit(text, f"copysignf(1.0f, theta) / ({root})",
                f"__fdividef(copysignf(1.0f, theta), {root})")
    return edit(text, "1.0f / sqrtf(fmaf(t, t, 1.0f))", "rsqrtf(fmaf(t, t, 1.0f))")


def build(name: str, text: str):
    out = _build.BUILD_DIR / "rounds"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                           str(out / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    lib.gflow_small_eig.argtypes = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2 + (
        ctypes.c_void_p,)
    lib.gflow_small_eig_stats.argtypes = (ctypes.c_void_p,)
    return lib, cs.small_eig_ptxas(proc.stdout + proc.stderr).get(9)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_small_eig_rounds: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    src = instrumented((ROOT / "gflow_tpu_torch" / "csrc" / "small_eig.cu").read_text())
    libs = {"ieee": build("ieee", src), "approx": build("approx", approx(src))}
    inputs = {"synthetic 9x9": cs.separated_symmetric(9, 512),
              **{k: v for k, v in cs.lmeds_eig_inputs().items() if k.endswith("9x9")}}
    rows = []
    for where, A in inputs.items():
        batch = A.shape[0]
        for tag, (lib, ptxas) in libs.items():
            stats = torch.zeros(batch, 4, dtype=torch.int64, device="cuda")
            out = torch.empty(batch, 9, device="cuda")
            assert lib.gflow_small_eig_stats(stats.data_ptr()) == 0
            call = lambda: lib.gflow_small_eig(A.data_ptr(), out.data_ptr(), batch, 9,
                                               torch.cuda.current_stream().cuda_stream)
            call()
            torch.cuda.synchronize()
            st = stats.double()
            rounds = st[:, 0] * 9  # M - 1 = 9 rounds a sweep at n = 9
            lam = torch.einsum("bi,bij,bj->b", out, A, out)
            res = float((torch.linalg.vector_norm(A @ out[..., None] - lam[:, None, None]
                                                  * out[..., None], dim=(1, 2))
                         / torch.linalg.matrix_norm(A)).max())
            rows.append({"input": where, "batch": batch, "build": tag,
                         "ms": cs.kernel_ms(call), "sweeps_mean": float(st[:, 0].mean()),
                         "sweeps_max": int(st[:, 0].max()),
                         "angle_cycles_per_round": float((st[:, 1] / rounds).mean()),
                         "update_cycles_per_round": float((st[:, 2] / rounds).mean()),
                         "slowest_matrix_cycles": int(st[:, 3].max()), "residual": res,
                         "ptxas": ptxas})
            print(json.dumps({**rows[-1], "card": smi}), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "small_eig_rounds.json").write_text(
        json.dumps({"card": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
