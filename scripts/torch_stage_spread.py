"""How far a full stage's loss trace through the kernels drifts from the
same stage through the plain versions, on the GPU, by stage variant.

    python3 scripts/torch_stage_spread.py

On chip_smoke.py's scene (854x480, 50,000 points, its check targets and
full-stage dynamics), under deterministic algorithms, runs each variant
(rebin_every, occ densify at iteration 0, iterations) through the kernels
and through the plain versions and prints the relative loss difference per
iteration: Adam turns rounding differences into lr-sized steps where a
gradient is ~0, so the gap grows with the stage's length.
"""
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

VARIANTS = ((4, True, 20), (4, False, 20), (1, False, 20), (1, True, 20), (4, True, 10))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from gflow_tpu_torch.opt.state import init_frame_state
    from gflow_tpu_torch.opt.train import StageConfig, train_stage

    img, depth, intr, params, n0, rcfg = cs.bench_scene()
    tg = cs.check_targets(img, depth)
    _, dyn = cs.dynamics()
    for rebin, occ, iters in VARIANTS:
        cfg = StageConfig(W=cs.W, H=cs.H, iterations=iters, render=rcfg, rebin_every=rebin,
                          densify_occ=occ, max_densify=256)
        traces = []
        for plain in (False, True):
            state = init_frame_state(cs.CAPACITY)._replace(
                n_alive=torch.tensor(n0, dtype=torch.int32, device="cuda"))
            gen = torch.Generator(device="cuda").manual_seed(5)
            with cs.deterministic(), (cs.plain_versions() if plain
                                      else contextlib.nullcontext()):
                _, _, info = train_stage(params, state, tg, intr, gen, cfg, dyn)
            traces.append(info["loss_trace"].cpu())
        rel = (traces[0] - traces[1]).abs() / traces[1].abs()
        print(f"rebin_every={rebin} occ_densify={occ} iterations={iters}: max rel diff "
              f"{float(rel.max()):.3e}; per iteration {[round(float(x), 5) for x in rel]}",
              flush=True)


if __name__ == "__main__":
    main()
