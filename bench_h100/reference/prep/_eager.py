"""What the frozen alignment module needs of the program, done plainly: the
device, Umeyama's similarity (a copy of the port's
``eval/camera_eval.umeyama_alignment``), and an eager runner in place of
the CUDA-graph cache (the reference runs every step as a plain call)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)


def graphed(dev) -> bool:
    return False


def graph_key(static, dev) -> tuple:
    return (static, str(dev))


def sync_check(dev, mode: str = "error"):
    return contextlib.nullcontext()


class Eager:
    def __init__(self, buffers):
        self.buffers = buffers

    def __call__(self, name: str, fn):
        return fn(self.buffers)


class GraphCache:
    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize

    def entry(self, *a, **k):
        raise RuntimeError("the reference runs eagerly")


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t
