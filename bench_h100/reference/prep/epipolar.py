"""The motion masks' epipolar fit done plainly, and the judge of the
program's: the LMedS of the port's ``pipeline/prep_moveseg.py`` (its
stand-in for upstream's cv2.findFundamentalMat(FM_LMEDS)) on the same
draws, solved in float64 by ``torch.linalg.eigh`` (or, for the control,
in float32 with TF32 matrix products), and the error map it writes.

The forward flow gives correspondences on a [-1, 1] grid (pixel centres);
512 minimal 8-point samples are solved (the null vector of A^T A, then the
rank-2 projection F (I - v v^T), v the null vector of F^T F), each scored
by the median of its squared Sampson errors over 8192 drawn
correspondences; the winner's robust sigma picks the inliers, F is refit
on them by least squares, and the map is its Sampson error scaled by
((H + W) / 2)^2 and normalised by its max. The draws come from a CPU
generator seeded 0 for every pair, as the program's."""
from __future__ import annotations

import numpy as np
import torch

from . import precision

N_SAMPLES, N_SCORE = 512, 8192


def _dtype():
    return torch.float32 if precision.MODE == "tf32" else torch.float64


def correspondences(flow: np.ndarray, device, dtype=torch.float64):
    """(H, W, 2) forward flow in pixels -> x1, x2 (H*W, 2) normalised."""
    H, W = flow.shape[:2]
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    x1 = np.stack([2 * (xx + 0.5) / W - 1, 2 * (yy + 0.5) / H - 1], -1).reshape(-1, 2)
    f = flow.astype(np.float64)
    x2 = x1 + np.stack([2 * f[..., 0] / (W - 1), 2 * f[..., 1] / (H - 1)], -1).reshape(-1, 2)
    t = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)
    return t(x1), t(x2)


def draws(N: int):
    """(N_SAMPLES, 8) minimal-sample indices and the scoring indices."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, N, (N_SAMPLES, 8), generator=g)
    return idx, torch.randint(0, N, (min(N_SCORE, N),), generator=g)


def design_rows(x1, x2):
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def null_vector(M):
    return torch.linalg.eigh(M)[1][..., :, 0]


def solve_f(A):
    """Least-squares F of design matrices A (..., M, 9), projected to rank 2."""
    F = null_vector(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 3)
    v = null_vector(F.transpose(-1, -2) @ F)[..., None]
    return F - (F @ v) @ v.transpose(-1, -2)


def sampson(x1, x2, F):
    """Squared Sampson distance of (N, 2) correspondences under F (..., 3, 3)."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)
    d1 = torch.einsum("...ij,nj->...ni", F, h1)
    d2 = torch.einsum("...ji,nj->...ni", F, h2)
    z = torch.einsum("ni,...ni->...n", h2, d1)
    denom = d1[..., 0] ** 2 + d1[..., 1] ** 2 + d2[..., 0] ** 2 + d2[..., 1] ** 2
    return z ** 2 / denom.clamp_min(1e-12)


def median_last(x):
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def error_png(x1, x2, F, H: int, W: int) -> np.ndarray:
    """The map as the program writes it: uint8(err / max * 255)."""
    err = (sampson(x1, x2, F) * ((H + W) / 2) ** 2).reshape(H, W).cpu().numpy()
    err = err / max(float(err.max()), 1e-12)
    return (err * 255).astype(np.uint8)


@torch.no_grad()
def lmeds(flow: np.ndarray, device) -> dict:
    """The LMedS of one pair: F (3, 3), the inlier mask (H*W,), the
    written map, and F's median on the scoring draws."""
    H, W = flow.shape[:2]
    with precision.fp32_math():
        x1, x2 = correspondences(flow, device, _dtype())
        idx, sc = (d.to(device) for d in draws(x1.shape[0]))
        Fs = solve_f(design_rows(x1[idx], x2[idx]))
        med = median_last(sampson(x1[sc], x2[sc], Fs))
        best = int(torch.argmin(med))
        sigma2 = (2.5 * 1.4826) ** 2 * med[best]
        inliers = sampson(x1, x2, Fs[best]) < sigma2.clamp_min(1e-12)
        F = solve_f(design_rows(x1, x2) * inliers[:, None])
        return {"F": F, "inliers": inliers, "png": error_png(x1, x2, F, H, W),
                "median": float(median_last(sampson(x1[sc], x2[sc], F)))}


@torch.no_grad()
def judge(flow: np.ndarray, F, inliers, png: np.ndarray, median_ref: float, device) -> dict:
    """An answer (F, its inlier mask, its written map) on the reference's
    flow, in float64:
    - ``map_off``: the share of pixels whose written level lies more than
      one level from F's own map (the quantisation);
    - ``refit_excess``: |the algebraic residual over the answer's own
      inliers of F (unit norm) over that of the float64 refit on them - 1|,
      the refit's solves and its rank-2 projection;
    - ``median_excess``: |F's median on the scoring draws over the
      reference F's - 1|, the LMedS objective.
    inf where the answer is missing or degenerate."""
    keys = ("map_off", "refit_excess", "median_excess")
    if F is None:
        return dict.fromkeys(keys, float("inf"))
    H, W = flow.shape[:2]
    x1, x2 = correspondences(flow, device)
    F = torch.as_tensor(F).to(device=device, dtype=torch.float64)
    _, sc = draws(x1.shape[0])
    med = float(median_last(sampson(x1[sc.to(device)], x2[sc.to(device)], F)))
    out = {"median_excess": abs(med / median_ref - 1.0) if median_ref > 0 else float("inf")}
    A = design_rows(x1, x2)[torch.as_tensor(inliers).to(device).reshape(-1)]
    if A.shape[0] < 8 or float(torch.linalg.matrix_norm(F)) == 0.0:
        out["refit_excess"] = float("inf")
    else:
        r = lambda G: float(torch.linalg.vector_norm(
            A @ (G / torch.linalg.matrix_norm(G)).reshape(9)) ** 2)
        out["refit_excess"] = abs(r(F) / max(r(solve_f(A)), 1e-300) - 1.0)
    own = error_png(x1, x2, F, H, W).astype(np.int16)
    out["map_off"] = float((np.abs(own - png.astype(np.int16)) > 1).mean())
    return out
