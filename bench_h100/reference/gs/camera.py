"""Pinhole camera model with a differentiable quaternion+translation pose.

Counterpart of ``gflow_tpu/core/camera.py``. Intrinsics are a 4-vector
[fx, fy, cx, cy]; the world->camera pose is a 7-vector (unit quaternion
xyzw + translation), materialized as a (3, 4) extrinsic on demand.
Unprojection uses fx for both axes, as the original GFlow does
(gflow/utils/geometry.py:104-116).

Conventions
-----------
- camera pose quaternion: **xyzw** (identity = [0, 0, 0, 1])
- Gaussian rotation quaternion (see ops/projection.py): **wxyz**
  (identity = [1, 0, 0, 0])
- extr is world->camera: x_cam = R @ x_world + t, shape (3, 4)
- pixel coordinates: x (u) is the column index, y (v) the row index.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._device import resolve_device


class Camera(NamedTuple):
    """Camera parameters: intrinsics and world->camera pose."""

    intr: torch.Tensor  # (4,) [fx, fy, cx, cy]
    pose: torch.Tensor  # (7,) [qx, qy, qz, qw, tx, ty, tz]

    @property
    def extr(self) -> torch.Tensor:
        return pose_to_extr(self.pose)

    def with_extr(self, extr) -> "Camera":
        """The camera with the pose of a (3, 4) world->camera matrix."""
        extr = torch.as_tensor(extr, dtype=torch.float32, device=self.pose.device)
        return self._replace(pose=torch.cat([rotmat_to_quat_xyzw(extr[:3, :3]), extr[:3, 3]]))


def default_intrinsics(W: int, H: int, device=None) -> torch.Tensor:
    """90-degree-fov default intrinsics on `device` (``cuda`` unless the
    caller passes another)."""
    fov = math.pi / 2.0
    fx = 0.5 * float(W) / math.tan(0.5 * fov)
    fy = 0.5 * float(H) / math.tan(0.5 * fov)
    return torch.tensor([fx, fy, W / 2.0, H / 2.0], dtype=torch.float32,
                        device=resolve_device(device))


def quat_xyzw_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes and converts an xyzw quaternion to a (3, 3) rotation."""
    q = q / torch.linalg.norm(q).clamp_min(1e-12)
    x, y, z, w = q[0], q[1], q[2], q[3]
    return _quat_components_to_rotmat(w, x, y, z)


def quat_wxyz_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes and converts wxyz quaternions (..., 4) to (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _quat_components_to_rotmat(w, x, y, z)


def _quat_components_to_rotmat(w, x, y, z):
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        dim=-1)
    row1 = torch.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        dim=-1)
    row2 = torch.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_quat_xyzw(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation -> xyzw quaternion (Shepperd's method: the candidate
    with the largest diagonal score is the numerically best one), w >= 0."""
    R = R.to(torch.float32)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr]),
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12]),
        torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20]),
        torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01]),
    ])
    best = torch.argmax(torch.stack([tr, m00, m11, m22]))
    q = cands[best]
    q = q / torch.linalg.norm(q).clamp_min(1e-12)
    return q * torch.where(q[3] < 0, -1.0, 1.0)


def pose_to_extr(pose: torch.Tensor) -> torch.Tensor:
    """(7,) quat-xyzw + translation -> (3, 4) world->camera matrix."""
    R = quat_xyzw_to_rotmat(pose[:4])
    return torch.cat([R, pose[4:7, None]], dim=1)


def extr_to_pose(extr: torch.Tensor) -> torch.Tensor:
    extr = extr.to(torch.float32)
    return torch.cat([rotmat_to_quat_xyzw(extr[:3, :3]), extr[:3, 3]])


def pix2world(uv, depth, intr, extr):
    """Unproject pixel coords + depth to world points.

    cam = [depth * (uv - pp) / fx, depth] (fx for BOTH axes, as the original
    GFlow), then x_world = R^T (x_cam - t).
    uv: (N, 2) pixel xy; depth: (N,) or (N, 1); returns (N, 3)."""
    depth = depth.reshape(-1, 1)
    cam = torch.cat([depth * (uv - intr[2:4]) / intr[0], depth], dim=-1)
    return (cam - extr[:3, 3]) @ extr[:3, :3]


def world2pix(xyz, intr, extr):
    """Project world points to (uv (N, 2), depth (N, 1)); depth 0 and uv
    -9999 encode a point behind the near plane."""
    cam = xyz @ extr[:3, :3].T + extr[:3, 3]
    z = cam[:, 2:3]
    visible = z > 0.01
    safe_z = torch.where(visible, z, 1.0)
    u = intr[0] * cam[:, 0:1] / safe_z + intr[2]
    v = intr[1] * cam[:, 1:2] / safe_z + intr[3]
    uv = torch.where(visible, torch.cat([u, v], dim=-1), -9999.0)
    return uv, torch.where(visible, z, 0.0)
