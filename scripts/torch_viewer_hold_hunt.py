"""Hunt the viewer hold's rare failure on the card: each run fits
chip_smoke.py's fit_video cut (a 4-frame 854x480 sequence, 3 frames fitted,
50,000 points) and then holds the viewer's renders of it against the plain
versions (chip_smoke.viewer_hold: 1e-5 but where alpha's steps or float32
rounding explain it), until a hold fails or N runs pass. The fit differs
from run to run (float atomics), so each run views another scene. Each run
records its render graphs in empty caches, dropped after it (the scenes'
shapes differ, and the process's caches would keep every run's graph
pools).

    python3 scripts/torch_viewer_hold_hunt.py --runs 60

A failing hold saves its compositor call under
logs/chip_smoke/hold_failures/; the hunt replays it there
(scripts/torch_replay_composite.py) and copies it to
chiprun_out/hold_failures/. A passing run still reports, per view, the
pixel where the kernel and the plain version lie farthest apart among
those with no slot at one of alpha's steps, replayed as a failing pixel
is (its distances from float64, chip_smoke.rounding_bound, the verdict).
One JSON line per run, then a summary, also written to
chiprun_out/viewer_hold_hunt.json.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import time
from unittest import mock

import torch

from torch_ab import ROOT, card

import chip_smoke as cs  # noqa: E402  (torch_ab put the root on sys.path)
import torch_replay_composite as replay  # noqa: E402


@contextlib.contextmanager
def fresh_render_caches():
    """Empty caches of the host-called renders' graphs while the block
    runs."""
    from gflow_tpu_torch.ops import render
    from gflow_tpu_torch.opt import graphs

    with contextlib.ExitStack() as stack:
        for name in ("RENDER_GRAPHS", "RENDER_TRAJ_GRAPHS", "QUANTIZE_GRAPHS"):
            old = getattr(render, name)
            stack.enter_context(mock.patch.object(
                render, name, graphs.ForwardCache(old.name, old.maxsize)))
        stack.enter_context(mock.patch.object(graphs, "DEFAULT_CACHE", graphs.GraphCache()))
        yield


def worst_pixel(rec):
    """The in-image pixel of one viewer compositor call where the kernel and
    the float32 plain version lie farthest apart, among those with no slot
    at one of alpha's steps, replayed (torch_replay_composite.replay)."""
    from gflow_tpu_torch.ops import composite

    out = replay.outputs(rec, rec["attrs"].device)
    px, py = composite.tile_pixels(rec["attrs"].shape[0], rec["n_tx"], rec["attrs"].device)
    diff = (out["kernel"] - out["plain"]).abs().amax(-1)
    diff = torch.where((px < cs.W) & (py < cs.H), diff, 0.0).flatten()
    top = diff.topk(64).indices
    t, p = top // 256, top % 256
    quiet = cs.cutoff_bound(rec, t, p) == 0
    if not bool(quiet.any()):
        return None
    t, p = t[quiet][:1], p[quiet][:1]
    row = replay.replay({**rec, "got": out["kernel"], "want": out["plain"], "tiles": t,
                         "pixels": p}, rec["attrs"].device)[0]
    row["kernel_vs_plain"] = float(diff[t * 256 + p][0])
    return {k: row[k] for k in ("tile", "pixel", "kernel_vs_plain", "kernel_vs_f64",
                                "plain_vs_f64", "rounding_bound", "verdict", "live_slots")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10, help="runs at most")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_viewer_hold_hunt: needs a CUDA device")
    from gflow_tpu_torch.viz.viewer import ViewerState

    smi = card()
    print(smi, flush=True)
    root = os.path.join(cs.FIT_DIR, "hunt")
    shutil.rmtree(cs.HOLD_FAILURES, ignore_errors=True)
    out_dir = ROOT / "chiprun_out" / "hold_failures"
    runs, failure = [], None
    for run in range(args.runs):
        t0 = time.perf_counter()
        shutil.rmtree(root, ignore_errors=True)
        worst = None
        with fresh_render_caches(), contextlib.redirect_stdout(sys.stderr):
            trainer, _, _ = cs.run_fit_video(root, "cuda")
            state = ViewerState(trainer.dir, device="cuda")
            views = cs.viewer_views(len(state.frames))
            try:
                packed, errs, steps = cs.viewer_hold(state, views)
                worst = {k: worst_pixel(rec) for k, rec in zip(views, packed)}
            except AssertionError as e:
                failure = {"run": run, "message": str(e)[:2000]}
                errs = steps = None
            del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        row = {"run": run, "max_abs_err": errs, "pixels_explained": steps,
               "worst_unstepped": worst, "seconds": time.perf_counter() - t0}
        runs.append(row)
        print(json.dumps(row), flush=True)
        if failure:
            break
    if failure:
        print(f"# run {failure['run']} failed: {failure['message']}", flush=True)
        out_dir.mkdir(parents=True, exist_ok=True)
        failure["records"] = []
        for name in sorted(os.listdir(cs.HOLD_FAILURES)):
            path = os.path.join(cs.HOLD_FAILURES, name)
            shutil.copy(path, out_dir / name)
            failure["records"].append({"file": name, "replay": replay.main([path])})
    worst = [w for r in runs if r["worst_unstepped"] for w in r["worst_unstepped"].values() if w]
    verdicts = [w["verdict"] for w in worst]
    summary = {"card": smi, "runs": len(runs), "failed_runs": int(failure is not None),
               "failure": failure,
               "worst_unstepped": {
                   "views": len(worst), **{v: verdicts.count(v) for v in set(verdicts)},
                   "max_kernel_vs_plain": max((w["kernel_vs_plain"] for w in worst), default=None),
                   "max_share_of_twice_the_bound": max(
                       (w["kernel_vs_plain"] / (2 * w["rounding_bound"]) for w in worst),
                       default=None)},
               "per_run": runs}
    print(json.dumps({k: v for k, v in summary.items() if k != "per_run"}), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "viewer_hold_hunt.json").write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
