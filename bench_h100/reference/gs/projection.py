"""Differentiable Gaussian projection + EWA splatting (plain PyTorch).

Counterpart of ``gflow_tpu/ops/projection.py``. It stays in autograd, so
gradients w.r.t. xyz / scale / rotation / intrinsics / camera pose need no
hand-written code — the camera-only stage relies on the pose gradients.

  Sigma3 = R diag(s^2) R^T
  t      = W x + c                       (camera-space point)
  J      = d(proj)/d(t)                  (2x3 affine approximation)
  Sigma2 = J W Sigma3 W^T J^T + 0.3 I    (low-pass dilation)
  conic  = Sigma2^{-1}  (upper-tri a, b, c)
  radius = ceil(3 sqrt(lambda_max))
"""
from __future__ import annotations

import torch

NEAR_PLANE = 0.01
DILATION = 0.3
TILE = 16


def compute_cov3d(scale: torch.Tensor, rotate_wxyz: torch.Tensor) -> torch.Tensor:
    """(N,3) scales + (N,4) wxyz quats -> (N,6) upper-triangular 3D covariance
    [xx, xy, xz, yy, yz, zz]."""
    q = rotate_wxyz / torch.linalg.norm(rotate_wxyz, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = scale[:, 0] ** 2
    s1 = scale[:, 1] ** 2
    s2 = scale[:, 2] ** 2
    c_xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c_xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c_xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c_yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c_yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c_zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def supported_max_radius(max_tiles_per_gaussian: int) -> float:
    """Largest projected 3-sigma radius (px) the binning stage's static
    candidate grid is guaranteed to cover when centered on the splat:
    (MX/2)*TILE - TILE/2 for the smaller grid axis."""
    from .binning import _rect_grid_dims

    mx, my = _rect_grid_dims(max_tiles_per_gaussian)
    return (min(mx, my) / 2) * TILE - TILE / 2


def project_gaussians(xyz, scale, rotate, intr, extr, W: int, H: int,
                      max_radius: float | None = None):
    """Full projection pipeline in one differentiable function.

    Returns a dict with:
      uv      (N, 2) pixel coords (-9999 where culled)
      depth   (N, 1) camera z; 0 where culled
      conic   (N, 3) inverse 2D covariance, upper-tri (a, b, c)
      radius  (N,)   3-sigma extent in pixels, 0 where culled
      visible (N,)   bool
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    Rw2c = extr[:3, :3]
    t = extr[:3, 3]
    X, Y, Z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cam_x = Rw2c[0, 0] * X + Rw2c[0, 1] * Y + Rw2c[0, 2] * Z + t[0]
    cam_y = Rw2c[1, 0] * X + Rw2c[1, 1] * Y + Rw2c[1, 2] * Z + t[1]
    z = Rw2c[2, 0] * X + Rw2c[2, 1] * Y + Rw2c[2, 2] * Z + t[2]
    visible = z > NEAR_PLANE
    safe_z = torch.where(visible, z, 1.0)

    u = fx * cam_x / safe_z + cx
    v = fy * cam_y / safe_z + cy

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = compute_cov3d(scale, rotate).unbind(-1)

    # EWA: clamp camera-space x/y to the (padded) frustum for stability
    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    tx = torch.clamp(cam_x / safe_z, -lim_x, lim_x) * safe_z
    ty = torch.clamp(cam_y / safe_z, -lim_y, lim_y) * safe_z

    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    # J rows (2x3): [fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # A = J @ W: a0 = j00*W0 + j02*W2 ; a1 = j11*W1 + j12*W2   (each (N, 3))
    W0, W1, W2 = Rw2c[0], Rw2c[1], Rw2c[2]
    a0 = j00[:, None] * W0[None, :] + j02[:, None] * W2[None, :]
    a1 = j11[:, None] * W1[None, :] + j12[:, None] * W2[None, :]

    def sigma_vec(a):  # Sigma3 @ a for row vectors a (N, 3)
        sx = c_xx * a[:, 0] + c_xy * a[:, 1] + c_xz * a[:, 2]
        sy = c_xy * a[:, 0] + c_yy * a[:, 1] + c_yz * a[:, 2]
        sz = c_xz * a[:, 0] + c_yz * a[:, 1] + c_zz * a[:, 2]
        return torch.stack([sx, sy, sz], dim=-1)

    s0 = sigma_vec(a0)
    cov2_a = torch.sum(a0 * s0, dim=-1) + DILATION
    cov2_b = torch.sum(a1 * s0, dim=-1)
    cov2_c = torch.sum(a1 * sigma_vec(a1), dim=-1) + DILATION

    if max_radius is not None:
        # isotropically shrink the 2D covariance so the 3-sigma radius never
        # exceeds what the binning stage's static per-Gaussian tile grid can
        # cover (oversized splats would otherwise render as hard-edged
        # squares whose gradients chase the artifact)
        mid0 = 0.5 * (cov2_a + cov2_c)
        det0 = cov2_a * cov2_c - cov2_b * cov2_b
        lam0 = mid0 + torch.sqrt(torch.clamp_min(mid0 * mid0 - det0, 0.1))
        shrink = torch.clamp_max(((max_radius / 3.0) ** 2) / lam0, 1.0)
        cov2_a = cov2_a * shrink
        cov2_b = cov2_b * shrink
        cov2_c = cov2_c * shrink

    det = cov2_a * cov2_c - cov2_b * cov2_b
    det_ok = det > 1e-12
    # the dilation guarantees det >= 0.3*(a+c) + 0.09; smaller values are fp
    # cancellation on huge covariances. Flooring the divisor bounds the
    # conic and the 1/det^2 terms of its gradient, which would otherwise
    # overflow f32 and poison Adam's moments with NaN.
    safe_det = torch.clamp_min(det, 9e-2)
    conic = torch.stack([cov2_c / safe_det, -cov2_b / safe_det,
                         cov2_a / safe_det], dim=-1)

    mid = 0.5 * (cov2_a + cov2_c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    # cull: behind near plane, degenerate cov, or fully off-screen
    on_screen = (u + radius > 0) & (u - radius < W) & (v + radius > 0) & (v - radius < H)
    visible = visible & det_ok & on_screen
    return {
        "uv": torch.where(visible[:, None], torch.stack([u, v], dim=-1), -9999.0),
        "depth": torch.where(visible, z, 0.0)[:, None],
        "conic": conic,
        "radius": torch.where(visible, radius, 0.0),
        "visible": visible,
    }
