"""The PSNR of chip_smoke.py's fit_video phase, scaled down to run on the CPU.

    python3 scripts/torch_fit_video_floor.py [--W 192 --H 108]

Writes chip_smoke's synthetic sequence (JPEG frames) at W x H, runs the
port's fit_video on it on the CPU with chip_smoke's FIT settings and
N_POINTS scaled by the area ratio, and prints the final frame's PSNR and
the move segmentation's fill: the reference for chip_smoke's PSNR_FLOOR.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--W", type=int, default=192)
    ap.add_argument("--H", type=int, default=108)
    args = ap.parse_args()
    n_points = round(chip_smoke.N_POINTS * args.W * args.H / (chip_smoke.W * chip_smoke.H))
    with tempfile.TemporaryDirectory() as root:
        trainer, _, wall = chip_smoke.run_fit_video(root, "cpu", W=args.W, H=args.H,
                                                    num_points=n_points)
        psnr, fill = chip_smoke.fit_video_outputs(trainer, args.W, args.H)
    print(json.dumps({"W": args.W, "H": args.H, "num_points": n_points, "psnr_db": psnr,
                      "seg_fill": fill, "wall_s": wall}))


if __name__ == "__main__":
    main()
