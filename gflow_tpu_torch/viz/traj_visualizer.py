"""Track-overlay visualizer (the original's CoTracker-derived
TrajVisualizer, gflow/utils/traj_visualizer.py:76-398): per-track rainbow
colors, fading polyline history, filled circles for visible points and
crosses for occluded ones, written as a video.

Counterpart of ``gflow_tpu/viz/traj_visualizer.py``: the same PIL
drawing, with the colors from the baked gist_rainbow table instead of
matplotlib.
"""
from __future__ import annotations

import os

import numpy as np

from .colormap import colormap_lookup


class TrajVisualizer:
    def __init__(self, save_dir=".", pad_value=0, linewidth=2, fps=5,
                 show_first_frame=2, tracks_leave_trace=-1, mode="rainbow"):
        self.save_dir = save_dir
        self.pad_value = pad_value
        self.linewidth = linewidth
        self.fps = fps
        self.show_first_frame = show_first_frame
        self.tracks_leave_trace = tracks_leave_trace  # -1 = full history
        self.mode = mode

    def _colors(self, tracks, still_length=None, query_frame=0):
        """Per-track rainbow colors by normalized y position at the query
        frame (traj_visualizer.py:212-221); when still_length splits the
        track list, the moving tail (indices >= still_length) is
        re-normalized over its own y-range (traj_visualizer.py:222-231)."""
        ys = np.asarray(tracks[query_frame, :, 1], np.float64)
        Q = ys.shape[0]

        def norm(v):
            lo, hi = v.min(), v.max()
            return (v - lo) / (hi - lo) if hi > lo else np.full_like(v, 0.5)

        u = norm(ys)
        if still_length is not None and 0 < still_length < Q:
            u[still_length:] = norm(ys[still_length:])
        return (colormap_lookup(u, "gist_rainbow") * 255).astype(np.uint8)

    def visualize(self, video, tracks, occulasions=None, filename="traj_vis",
                  still_length=None):
        """video: (1, T, 3, H, W) float [0, 255] or uint8; tracks: (1, T, Q,
        2) pixel xy; occulasions: (1, T, Q) bool."""
        from PIL import Image, ImageDraw

        video = np.asarray(video)[0]
        tracks = np.asarray(tracks)[0]
        occ = None if occulasions is None else np.asarray(occulasions)[0]
        T, Q = tracks.shape[:2]
        T = min(T, video.shape[0])
        colors = self._colors(tracks, still_length=still_length)
        pad = self.pad_value
        r = self.linewidth + 1

        frames_out = []
        for t in range(T):
            frame = np.clip(video[t].transpose(1, 2, 0), 0, 255).astype(np.uint8)
            if pad:
                frame = np.pad(frame, ((pad, pad), (pad, pad), (0, 0)))
            img = Image.fromarray(frame).convert("RGB")
            draw = ImageDraw.Draw(img)
            start = 0 if self.tracks_leave_trace < 0 else max(0, t - self.tracks_leave_trace)
            # fading history polylines
            for s in range(start, t):
                fade = (s - start + 1) / max(t - start, 1)
                for q in range(Q):
                    c = tuple((colors[q] * fade).astype(int))
                    x1, y1 = tracks[s, q] + pad
                    x2, y2 = tracks[s + 1, q] + pad
                    draw.line([(x1, y1), (x2, y2)], fill=c, width=self.linewidth)
            # current points: discs, crosses where occluded
            for q in range(Q):
                x, y = tracks[t, q] + pad
                c = tuple(int(v) for v in colors[q])
                if occ is not None and occ[t, q]:
                    draw.line([(x - r, y - r), (x + r, y + r)], fill=c, width=self.linewidth)
                    draw.line([(x - r, y + r), (x + r, y - r)], fill=c, width=self.linewidth)
                else:
                    draw.ellipse([x - r, y - r, x + r, y + r], fill=c)
            frames_out.append(np.asarray(img))

        frames_full = [frames_out[0]] * (self.show_first_frame - 1) + frames_out
        from .video import save_video

        os.makedirs(self.save_dir, exist_ok=True)
        save_video(os.path.join(self.save_dir, f"{filename}.mp4"), frames_full, self.fps)
        return frames_full
