"""Point-track bookkeeping helpers (reference: gflow/utils/tracking.py)."""
from __future__ import annotations

import numpy as np


def find_closest_point(uv: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """For each query coord, index of the nearest uv point
    (reference: tracking.py:24-26)."""
    d = np.sum((uv[:, None] - coords[None]) ** 2, axis=-1)
    return np.argmin(d, axis=0)


def process_traj_to_tracks(sequence_traj) -> np.ndarray:
    """list of (Q, 2) per-frame uv -> (1, T, Q, 2) float tracks
    (reference: tracking.py:5-8)."""
    return np.stack(sequence_traj)[None].astype(np.float32)


def process_occu(sequence_traj_occlusion, tracks) -> np.ndarray:
    """Occlusion heuristic: a track initially in the still region is occluded
    in frame i iff it falls inside frame i's move segmentation
    (reference: tracking.py:10-22)."""
    tracks = tracks.copy()
    H, W = sequence_traj_occlusion[0].shape[:2]
    tracks[..., 0] = tracks[..., 0].clip(0, W - 1)
    tracks[..., 1] = tracks[..., 1].clip(0, H - 1)
    T = len(sequence_traj_occlusion)
    Q = tracks.shape[2]
    occ = np.zeros((1, T, Q), bool)
    seg0 = sequence_traj_occlusion[0]
    moving0 = np.array(
        [
            seg0[int(round(tracks[0, 0, j, 1])), int(round(tracks[0, 0, j, 0]))]
            for j in range(Q)
        ]
    )
    for i, seg in enumerate(sequence_traj_occlusion):
        for j in range(Q):
            v = seg[int(round(tracks[0, i, j, 1])), int(round(tracks[0, i, j, 0]))]
            occ[0, i, j] = (not moving0[j]) and bool(v)
    return occ


def extract_first_visible_points(points, occluded):
    first = np.argmax(~occluded, axis=1)
    pts = points[np.arange(points.shape[0]), first, -1::-1]
    return np.column_stack((first, pts))
