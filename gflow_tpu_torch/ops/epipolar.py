"""Fundamental-matrix estimation (LMedS) and the Sampson error, in torch.

Counterpart of ``gflow_tpu/ops/epipolar.py``, which replaces
cv2.findFundamentalMat(FM_LMEDS) in the reference's motion-mask
preparation. The LMedS is batched: `n_samples` random 8-point minimal
samples are solved at once (batched 9x9 eigendecompositions, then a
rank-2 SVD), scored by the median of their squared Sampson errors over
`n_score` subsampled correspondences, and the winner is refit by least
squares on its inliers. The median of an even count is the mean of the two
middle values, as ``jnp.median``'s (``torch.median`` returns the lower).
"""
from __future__ import annotations

import torch


def _design_rows(x1, x2):
    """Rows of the 8-point design matrix (x2^T F x1 = 0): (..., 2) x2 ->
    (..., 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def _solve_f(A):
    """Least-squares F from design matrices A (..., M, 9): the null vector
    of A^T A, then rank-2 enforcement."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)  # ascending eigenvalues
    F = V[..., :, 0].reshape(*A.shape[:-2], 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., None] * Vh)


def sampson_error(x1, x2, F):
    """Squared Sampson distance. x1, x2: (N, 2); F: (..., 3, 3) ->
    (..., N)."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)
    d1 = torch.einsum("...ij,nj->...ni", F, h1)   # F x1
    d2 = torch.einsum("...ji,nj->...ni", F, h2)   # F^T x2
    z = torch.einsum("ni,...ni->...n", h2, d1)
    denom = d1[..., 0] ** 2 + d1[..., 1] ** 2 + d2[..., 0] ** 2 + d2[..., 1] ** 2
    return z ** 2 / denom.clamp_min(1e-12)


def median_last(x):
    """Median over the last axis; an even count averages the two middle
    values ((lo + hi) * 0.5, as jnp.median)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def lmeds_draws(N: int, generator: torch.Generator | None = None, n_samples: int = 512,
                n_score: int = 8192):
    """The LMedS's random draws: (n_samples, 8) minimal-sample indices and
    min(n_score, N) scoring indices into N correspondences, from
    `generator` (a CPU generator; default: seed 0)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    idx = torch.randint(0, N, (n_samples, 8), generator=g)
    return idx, torch.randint(0, N, (min(n_score, N),), generator=g)


def find_fundamental_lmeds(x1, x2, generator: torch.Generator | None = None,
                           n_samples: int = 512, n_score: int = 8192, draws=None):
    """x1, x2: (N, 2) normalized coordinates (tensors on one device) ->
    (F (3, 3), inlier mask (N,)). `draws` = (idx, score_idx) replaces the
    random draws of ``lmeds_draws``.

    Among `n_samples` minimal solutions, the one with the lowest median
    squared Sampson error on the scoring subsample wins; robust sigma =
    1.4826 sqrt(median), inliers have error < (2.5 sigma)^2, and F is
    refit on them by least squares."""
    if draws is None:
        draws = lmeds_draws(x1.shape[0], generator, n_samples, n_score)
    idx, score_idx = (d.to(x1.device) for d in draws)
    Fs = _solve_f(_design_rows(x1[idx], x2[idx]))          # (S, 3, 3)
    med = median_last(sampson_error(x1[score_idx], x2[score_idx], Fs))
    best = torch.argmin(med)
    sigma2 = (2.5 * 1.4826) ** 2 * med[best]
    inliers = sampson_error(x1, x2, Fs[best]) < sigma2.clamp_min(1e-12)
    F = _solve_f(_design_rows(x1, x2) * inliers[:, None])
    return F, inliers
