"""Unpack a TAP-Vid DAVIS pickle into per-scene frames + tracking.pkl
(capability parity with utility/split_tapvid_davis.py: writes <root>/<scene>/
<scene>/XXXXX.jpg and tracking.pkl holding {points, occluded}).

Counterpart of ``gflow_tpu/pipeline/split_tapvid.py``; the frames go
through ``core.io.imwrite`` (PIL), where the JAX package calls imageio,
whose JPEG plugin is PIL with the same default quality."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..core.io import imwrite


def main(pkl_path: str, out_root: str):
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)

    for scene, payload in data.items():
        scene_dir = Path(out_root) / scene / scene
        scene_dir.mkdir(parents=True, exist_ok=True)
        video = payload["video"]  # (T, H, W, 3) uint8
        for t, frame in enumerate(video):
            imwrite(scene_dir / f"{t:05d}.jpg", np.asarray(frame))
        with open(scene_dir / "tracking.pkl", "wb") as f:
            pickle.dump(
                {"points": payload["points"], "occluded": payload["occluded"]},
                f,
            )
        print(f"[split_tapvid] {scene}: {len(video)} frames")
    return out_root
