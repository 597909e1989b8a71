"""Replay one packed compositor call that a failed hold saved
(chip_smoke.py's save_hold_failure, under logs/chip_smoke/hold_failures/)
and settle each of its failing pixels.

    python3 scripts/torch_replay_composite.py <record.pt> [--device cuda|cpu]

On cuda (the default) the call runs through its kernel (K1, or K2 where the
record has with_cov; ops/cuda_raster.py), the float32 plain version and the
float64 plain version (composite.composite_packed on attrs.double()); on
cpu through the two plain versions only, and the record's `got` stands for
the kernel. Each failing pixel gets one JSON line: the kernel's and the
float32 plain version's distance from float64, replayed and as recorded;
the float32 rounding bound E of one evaluation there
(chip_smoke.rounding_bound); a verdict; and each heavy slot (blend weight
> 1e-3): alpha, power, the sum of |power|'s terms and the weight. Verdicts:

- "fault": the kernel lies farther from float64 than the plain version by
  more than E;
- "rounding": both lie within E of float64;
- "unsettled": neither.

The last line counts the verdicts.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gflow_tpu_torch.ops import composite  # noqa: E402


def outputs(rec, device):
    """The record's call replayed: {"kernel" (cuda only), "plain", "f64"},
    each (T, P, F)."""
    from gflow_tpu_torch.ops import cuda_raster

    args = (rec["counts"], rec["bg"], rec["n_tx"], rec["with_cov"], rec["row0"])
    first = lambda res: res[0] if rec["with_cov"] else res
    out = {"plain": first(composite.composite_packed(rec["attrs"], *args)),
           "f64": first(composite.composite_packed(
               rec["attrs"].double(), rec["counts"], rec["bg"].double(), *args[2:]))}
    if device.type == "cuda":
        out["kernel"] = first(cuda_raster.composite_fwd(rec["attrs"], *args))
    return out


def heavy_slots(rec, t, p, min_weight=1e-3):
    """Each slot of blend weight > min_weight at pixel p of tile t
    (chip_smoke.pixel_slots): slot, alpha, power, |power|'s terms,
    weight."""
    dev = rec["attrs"].device
    at = cs.pixel_slots(rec, torch.tensor([t], device=dev), torch.tensor([p], device=dev))
    slots = {k: v[0] for k, v in at.items()}
    return [{"slot": k, **{name: float(v[k]) for name, v in slots.items()}}
            for k in (slots["weight"] > min_weight).nonzero().flatten().tolist()]


def replay(rec, device):
    """One row per failing pixel of the record (module docstring)."""
    rec = {k: v.to(device) if torch.is_tensor(v) else v for k, v in rec.items()}
    out = outputs(rec, device)
    kernel = out.get("kernel", rec["got"])
    t, p = rec["tiles"], rec["pixels"]
    bound = cs.rounding_bound(rec, t, p)
    rows = []
    for i, (ti, pi) in enumerate(zip(t.tolist(), p.tolist())):
        ref = out["f64"][ti, pi]
        dist = lambda x: float((x[ti, pi].double() - ref).abs().max())
        k_d, p_d, e = dist(kernel), dist(out["plain"]), float(bound[i])
        verdict = ("fault" if k_d - p_d > e else "rounding" if max(k_d, p_d) <= e
                   else "unsettled")
        rows.append({"tile": ti, "pixel": pi, "f64": ref.tolist(),
                     "kernel_vs_f64": k_d, "plain_vs_f64": p_d,
                     "recorded_kernel_vs_f64": dist(rec["got"]),
                     "recorded_plain_vs_f64": dist(rec["want"]),
                     "kernel_replayed": "kernel" in out, "rounding_bound": e,
                     "verdict": verdict, "live_slots": int(rec["counts"][ti]),
                     "heavy_slots": heavy_slots(rec, ti, pi)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("record", type=Path, help="a .pt file saved by a failed hold")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_replay_composite: --device cuda needs a CUDA device")
    rec = torch.load(args.record, map_location="cpu")
    rows = replay(rec, torch.device(args.device))
    for r in rows:
        print(json.dumps(r), flush=True)
    verdicts = [r["verdict"] for r in rows]
    print(json.dumps({"record": str(args.record), "phase": rec["phase"], "view": rec["view"],
                      "device": args.device, "pixels": len(rows),
                      **{v: verdicts.count(v) for v in ("fault", "rounding", "unsettled")}}))
    return rows


if __name__ == "__main__":
    main()
