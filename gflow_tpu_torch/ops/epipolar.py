"""Fundamental-matrix estimation (LMedS) and the Sampson error, in torch.

Counterpart of ``gflow_tpu/ops/epipolar.py``, which replaces
cv2.findFundamentalMat(FM_LMEDS) in the reference's motion-mask
preparation. The LMedS is batched: `n_samples` random 8-point minimal
samples are solved at once (the null vector of each A^T A, then the
rank-2 projection), scored by the median of their squared Sampson errors
over `n_score` subsampled correspondences, and the winner is refit by
least squares on its inliers. The median of an even count is the mean of
the two middle values, as ``jnp.median``'s (``torch.median`` returns the
lower).

The JAX package jits the LMedS, one compile per shape; here, on a CUDA
device, it replays one CUDA graph per (N, n_samples, n_score, device)
(``LMEDS_GRAPHS``, an ``opt.graphs.ForwardCache``): the draws, made on the
host, are copied into the graph's buffers outside the capture. Both
eigenproblems take the eigenvector of the smallest eigenvalue
(``smallest_eigvec``): the null vector of A^T A (9 x 9), and v of F^T F
(3 x 3), for F's rank-2 projection F (I - v v^T) = U diag(s1, s2, 0) V^T.
On CUDA tensors that is the hand-written kernel ``csrc/small_eig.cu``
(cyclic Jacobi: one warp per matrix at n >= 5, the disjoint rotations of
a round at once; one thread per matrix below): ``torch.linalg.eigh`` and
``svd`` read their status back to the host, which a capture refuses. CPU
tensors take its plain version, ``torch.linalg.eigh``.
"""
from __future__ import annotations

import torch

from ..opt import graphs
from . import _build

# the LMedS's graphs: one per (N, n_samples, n_score), device and recording
# context (the JAX package's jit cache of find_fundamental_lmeds)
LMEDS_GRAPHS = graphs.ForwardCache("lmeds", 8)


def _design_rows(x1, x2):
    """Rows of the 8-point design matrix (x2^T F x1 = 0): (..., 2) x2 ->
    (..., 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def smallest_eigvec_plain(M):
    """The plain version of ``small_eig``: torch.linalg.eigh's eigenvector
    of the smallest eigenvalue (ascending order, lower triangle)."""
    return torch.linalg.eigh(M)[1][..., :, 0]


def small_eig(M):
    """The ``small_eig`` kernel on CUDA tensors: M (..., n, n) float32, 1 <=
    n <= 9, symmetric (its lower triangle is read) -> (..., n), the unit
    eigenvector of each matrix's smallest eigenvalue (its sign is
    arbitrary, as eigh's). Raises on other input."""
    n = M.shape[-1]
    if M.dtype != torch.float32 or M.dim() < 2 or M.shape[-2] != n or not 1 <= n <= 9:
        raise ValueError(f"small_eig: need float32 (..., n, n) with n <= 9, got {M.dtype} "
                         f"{tuple(M.shape)}")
    flat = M.reshape(-1, n, n).contiguous()
    out = torch.empty(flat.shape[:2], dtype=torch.float32, device=M.device)
    if flat.shape[0]:
        _build.launch("small_eig", flat, out, flat.shape[0], n)
    return out.reshape(M.shape[:-1])


def smallest_eigvec(M):
    """The unit eigenvector of the smallest eigenvalue of each symmetric
    matrix of M (..., n, n): the plain version for a CPU tensor, the
    ``small_eig`` kernel for any other (it launches or raises)."""
    if M.device.type == "cpu":
        return smallest_eigvec_plain(M)
    return small_eig(M)


def _solve_f(A):
    """Least-squares F from design matrices A (..., M, 9): the null vector
    of A^T A, then the rank-2 projection F (I - v v^T), v the null vector
    of F^T F (F v = s3 u3, so this is U diag(s1, s2, 0) V^T)."""
    F = smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 3)
    v = smallest_eigvec(F.transpose(-1, -2) @ F)[..., None]
    return F - (F @ v) @ v.transpose(-1, -2)


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


def _lmeds(x1, x2, idx, score_idx):
    """find_fundamental_lmeds on the draws, with no read back to the host:
    the winner is picked on the device (index_select, where indexing by a
    0-d tensor would read it)."""
    Fs = _solve_f(_design_rows(x1[idx], x2[idx]))          # (S, 3, 3)
    med = median_last(sampson_error(x1[score_idx], x2[score_idx], Fs))
    best = torch.argmin(med).reshape(1)
    sigma2 = (2.5 * 1.4826) ** 2 * med.index_select(0, best)[0]
    inliers = sampson_error(x1, x2, Fs.index_select(0, best)[0]) < sigma2.clamp_min(1e-12)
    F = _solve_f(_design_rows(x1, x2) * inliers[:, None])
    return F, inliers


def find_fundamental_lmeds(x1, x2, generator: torch.Generator | None = None,
                           n_samples: int = 512, n_score: int = 8192, draws=None):
    """x1, x2: (N, 2) normalized coordinates (tensors on one device) ->
    (F (3, 3), inlier mask (N,)). `draws` = (idx, score_idx) replaces the
    random draws of ``lmeds_draws``. On a CUDA device the replay of a CUDA
    graph (module docstring); a capture or replay that fails raises.

    Among `n_samples` minimal solutions, the one with the lowest median
    squared Sampson error on the scoring subsample wins; robust sigma =
    1.4826 sqrt(median), inliers have error < (2.5 sigma)^2, and F is
    refit on them by least squares."""
    if draws is None:
        draws = lmeds_draws(x1.shape[0], generator, n_samples, n_score)
    idx, score_idx = draws
    return LMEDS_GRAPHS("lmeds", _lmeds, dict(x1=x1, x2=x2, idx=idx, score_idx=score_idx),
                        x1.device)
