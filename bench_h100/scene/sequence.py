"""The benchmark's synthetic DAVIS-like video, made from a seed.

A periodic sequence of `period` frames: a camera on a closed path
(translation plus yaw, identity at frame 0) looks at a textured background
plane and one textured square on a plane in front of it, which moves on a
closed path of its own. Frame k and frame k + period are the same frame, so
a driver that feeds the frames cyclically never runs out and frame
`period` follows frame `period - 1` as frame 1 follows frame 0.

The geometry (sizes, paths, depths, focal length) is fixed by the traffic
parameters alone; the seed draws only the textures (phases and noise), so
every seed asks for the same kind of work.

``write_sequence`` writes the directory layout that the port's fit_video
discovers (JPEG frames; ``_depth_mast3r_s2/*.npy``, ``_camera_mast3r_s2/
*.json``, ``_flow_unimatch/*_pred.flo`` and ``*_occ_bwd.png``,
``_epipolar/*_open.png``, ``_mask/00000.png``) with its own writers, and
``write_frames`` the frames alone, for the prior preparation. It derives
from the repository's ``tests/synth.py`` (its moving-camera mode), without
that file's import of the JAX package and made periodic.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

Z_BG, Z_OBJ = 2.0, 1.5


def _yaw_pose(theta, center):
    """w2c 4x4 of a camera yawed by theta about Y with its optical centre at
    `center` (world)."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = -R @ np.asarray(center, float)
    return M


def _bilinear(tex, x, y):
    """Clamp-edge bilinear sample of an (H, W, C) texture at float (x, y)."""
    H, W = tex.shape[:2]
    x = np.clip(x, 0.0, W - 1.0)
    y = np.clip(y, 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0).astype(np.float32)[..., None]
    wy = (y - y0).astype(np.float32)[..., None]
    flat = tex.reshape(H * W, -1)
    at = lambda yi, xi: flat[yi * W + xi]
    top = at(y0, x0) + wx * (at(y0, x1) - at(y0, x0))
    bottom = at(y1, x0) + wx * (at(y1, x1) - at(y1, x0))
    return top + wy * (bottom - top)


def _texture(rng, H, W, octaves, base):
    """Smooth colour field plus `octaves` sine octaves and fine noise."""
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    tex = np.stack([xx, yy, 0.4 + 0.2 * np.sin(7 * xx) * np.cos(5 * yy)], -1)
    tex = 0.5 * tex + 0.5 * np.asarray(base)
    for o in range(octaves):
        f = 11.0 * 2 ** o
        ph = rng.uniform(0, 2 * np.pi, 3)
        ang = rng.uniform(0, np.pi, 3)  # each octave and channel its own direction
        tex = tex + (0.25 / 2 ** o) * np.sin(
            f * (np.cos(ang) * xx[..., None] + np.sin(ang) * yy[..., None]) + ph)
    tex = tex + rng.normal(0, 0.02, tex.shape)
    return np.clip(tex, 0, 1).astype(np.float32)


class Sequence:
    """The geometry and textures of one seed's video (see the module
    docstring). `traffic` holds the parameters: width, height, period,
    object_side (px at frame 0), object_radius_x / _y (px of its closed
    path), camera_shift (world units), camera_yaw_deg, texture_octaves."""

    def __init__(self, traffic: dict, seed: int):
        self.W, self.H = int(traffic["width"]), int(traffic["height"])
        self.period = int(traffic["period"])
        self.focal = 80.0 * self.W / 96.0
        self.ppx, self.ppy = self.W / 2, self.H / 2
        rng = np.random.default_rng(seed % 2 ** 63)
        octaves = int(traffic["texture_octaves"])
        # the background texture covers the view of every pose with margin
        self.bg_tex = _texture(rng, self.H, self.W, octaves, (0.3, 0.5, 0.4))
        self.obj_tex = _texture(rng, 128, 128, octaves, (0.9, 0.3, 0.2))
        self.side = float(traffic["object_side"])
        self.rx, self.ry = float(traffic["object_radius_x"]), float(traffic["object_radius_y"])
        self.shift = float(traffic["camera_shift"])
        self.yaw = np.deg2rad(float(traffic["camera_yaw_deg"]))

    def phase(self, t: int) -> float:
        return 2 * np.pi * (t % self.period) / self.period

    def pose(self, t: int) -> np.ndarray:
        """w2c 4x4 of frame t: a closed path, identity at t = 0."""
        p = self.phase(t)
        centre = np.array([self.shift * np.sin(p), 0.4 * self.shift * np.sin(2 * p),
                           0.5 * self.shift * (1 - np.cos(p))])
        return _yaw_pose(self.yaw * np.sin(p), centre)

    def object_corner(self, t: int):
        """Top-left corner (near-plane px of frame 0's camera) of the square
        at frame t, on an ellipse around the image centre."""
        p = self.phase(t)
        return (self.ppx - self.side / 2 + self.rx * np.sin(p),
                self.ppy - self.side / 2 + self.ry * (1 - np.cos(p)) - self.ry / 2)

    def _rays(self, t):
        pose = self.pose(t)
        R, tr = pose[:3, :3], pose[:3, 3]
        C = -R.T @ tr
        if not hasattr(self, "_d"):
            u, v = np.meshgrid(np.arange(self.W, dtype=float),
                               np.arange(self.H, dtype=float), indexing="xy")
            self._d = np.stack([(u - self.ppx) / self.focal, (v - self.ppy) / self.focal,
                                np.ones_like(u)], -1)
        return C, self._d @ R

    def _hit(self, C, dw, Z):
        s = (Z - C[2]) / dw[..., 2]
        return C + s[..., None] * dw

    def _on_object(self, P, t):
        """(inside, u, v): whether world points P on the object plane lie on
        the square at frame t, and their texture coordinates."""
        un = self.focal * P[..., 0] / Z_OBJ + self.ppx
        vn = self.focal * P[..., 1] / Z_OBJ + self.ppy
        x0, y0 = self.object_corner(t)
        su, sv = (un - x0) / self.side, (vn - y0) / self.side
        return (su >= 0) & (su < 1) & (sv >= 0) & (sv < 1), su, sv

    def render(self, t: int):
        """(image (H, W, 3) float32, depth (H, W) float32, object mask, world
        point of each pixel) of frame t."""
        C, dw = self._rays(t)
        Po = self._hit(C, dw, Z_OBJ)
        inside, su, sv = self._on_object(Po, t)
        Pb = self._hit(C, dw, Z_BG)
        ub = self.focal * Pb[..., 0] / Z_BG + self.ppx
        vb = self.focal * Pb[..., 1] / Z_BG + self.ppy
        img = _bilinear(self.bg_tex, ub, vb)
        n = self.obj_tex.shape[0] - 1
        img[inside] = _bilinear(self.obj_tex, su[inside] * n, sv[inside] * n)
        P = np.where(inside[..., None], Po, Pb)
        pose = self.pose(t)
        depth = (P @ pose[:3, :3].T + pose[:3, 3])[..., 2]
        return img.astype(np.float32), depth.astype(np.float32), inside, P

    def project(self, P, t):
        pose = self.pose(t)
        pc = P @ pose[:3, :3].T + pose[:3, 3]
        return np.stack([self.focal * pc[..., 0] / pc[..., 2] + self.ppx,
                         self.focal * pc[..., 1] / pc[..., 2] + self.ppy], -1)

    def object_step(self, t: int) -> np.ndarray:
        """World displacement of the square from frame t to t + 1."""
        a, b = self.object_corner(t), self.object_corner(t + 1)
        return np.array([(b[0] - a[0]) * Z_OBJ / self.focal,
                         (b[1] - a[1]) * Z_OBJ / self.focal, 0.0])

    def flow_and_occlusion(self, t: int, inside, P):
        """Forward flow t -> t + 1 of every pixel of frame t, and the pixels
        of frame t + 1 that frame t did not see (background the square
        uncovered), as the fwd-bwd check marks them."""
        P_next = P + np.where(inside[..., None], self.object_step(t), 0.0)
        u, v = np.meshgrid(np.arange(self.W, dtype=float), np.arange(self.H, dtype=float),
                           indexing="xy")
        flow = (self.project(P_next, t + 1) - np.stack([u, v], -1)).astype(np.float32)
        # a background point of frame t + 1, seen from frame t's camera,
        # hidden behind the square there
        C1, dw1 = self._rays(t + 1)
        Pb1 = self._hit(C1, dw1, Z_BG)
        pose = self.pose(t)
        C0 = -pose[:3, :3].T @ pose[:3, 3]
        s = (Z_OBJ - C0[2]) / (Pb1[..., 2] - C0[2])
        X = C0 + s[..., None] * (Pb1 - C0)
        hidden, _, _ = self._on_object(X, t)
        inside1, _, _ = self._on_object(self._hit(C1, dw1, Z_OBJ), t + 1)
        return flow, hidden & ~inside1


def _u8(x):
    return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)


def _imwrite(path, arr, quality=95):
    from PIL import Image

    kw = {"quality": quality} if str(path).endswith(".jpg") else {}
    Image.fromarray(arr).save(path, **kw)


def _write_flo(path, flow):
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([202021.25], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        np.ascontiguousarray(flow, np.float32).tofile(f)


def write_frames(seq: Sequence, root, n_frames: int | None = None, name="synth") -> Path:
    """The JPEG frames alone (0..n_frames-1, cyclic), under root/name/name."""
    out = Path(root) / name / name
    out.mkdir(parents=True)
    for t in range(seq.period if n_frames is None else n_frames):
        _imwrite(out / f"{t:05d}.jpg", _u8(seq.render(t)[0]))
    return out


def write_sequence(seq: Sequence, root, name="synth", threads: int = 4) -> Path:
    """One period of frames with the priors fit_video reads; the flow and
    occlusion of frame period - 1 lead to frame period (= frame 0). NumPy
    releases the interpreter lock in its array work, so a few threads
    write frames side by side."""
    from concurrent.futures import ThreadPoolExecutor

    out = Path(root) / name / name
    out.mkdir(parents=True)
    for sfx in ("_depth_mast3r_s2", "_camera_mast3r_s2", "_flow_unimatch", "_epipolar",
                "_mask"):
        Path(str(out) + sfx).mkdir()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda t: _write_frame(seq, out, t), range(seq.period)))
    return out


def _write_frame(seq: Sequence, out: Path, t: int) -> None:
    img, depth, inside, P = seq.render(t)
    stem = f"{t:05d}"
    _imwrite(out / f"{stem}.jpg", _u8(img))
    np.save(str(out) + f"_depth_mast3r_s2/{stem}.npy", depth)
    with open(str(out) + f"_camera_mast3r_s2/{stem}.json", "w") as f:
        json.dump({"focal": seq.focal, "pose": seq.pose(t).tolist(),
                   "pp": [seq.ppx, seq.ppy]}, f)
    _imwrite(str(out) + f"_epipolar/{stem}_open.png", (inside * 255).astype(np.uint8))
    if t == 0:
        _imwrite(str(out) + f"_mask/{stem}.png", (inside * 255).astype(np.uint8))
    flow, occ = seq.flow_and_occlusion(t, inside, P)
    _write_flo(str(out) + f"_flow_unimatch/{stem}_pred.flo", flow)
    _imwrite(str(out) + f"_flow_unimatch/{stem}_occ_bwd.png", (occ * 255).astype(np.uint8))


def frame_files(seq_dir, period: int, k: int) -> dict:
    """The files of global frame k >= 1 of the cyclic feed: its image,
    depth and move mask, and the flow and occlusion of the pair (k - 1, k)."""
    s, i, j = str(seq_dir), k % period, (k - 1) % period
    return {"image": os.path.join(s, f"{i:05d}.jpg"),
            "depth": s + f"_depth_mast3r_s2/{i:05d}.npy",
            "move_mask": s + f"_epipolar/{i:05d}_open.png",
            "flow": s + f"_flow_unimatch/{j:05d}_pred.flo",
            "occ": s + f"_flow_unimatch/{j:05d}_occ_bwd.png"}
