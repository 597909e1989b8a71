"""Multi-view global alignment of two-view pointmaps.

Counterpart of ``gflow_tpu/models/mast3r/alignment.py`` (MASt3R's
sparse_global_alignment as the reference uses it): a `logwin` pair graph,
per-edge relative poses by confidence-weighted Umeyama, a spanning-chain
initialization of the absolute poses, then Adam over per-frame pose
(quaternion + translation) and log depth-scale in two stages (lr 0.07 x
500, lr 0.014 x 200) minimizing the confidence-weighted cross-edge 3D
disagreement on subsampled pixels, and a shared focal from the canonical
pointmaps.

The host NumPy parts are copied, and draw from the same
``np.random.default_rng(seed)``, so the refinement's inputs equal the JAX
package's. The refinement runs in torch (autograd and a hand-written Adam
equal to ``optax.adam`` under ``optax.cosine_decay_schedule``) as an eager
loop on the caller's device: ``torch.optim.Adam`` cannot express its
per-group update scaling.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ... import resolve_device
from ...eval.camera_eval import umeyama_alignment

ROT_SCALE = 0.05  # update scale of rotations and log-scales (see _refine)


def make_pairs_logwin(n_frames: int, winsize: int = 3, symmetric: bool = True):
    """logwin-`winsize`-noncyclic pair graph: edges (i, i + 2^k), k < winsize.

    symmetric=True also emits the reversed pairs (DUSt3R's make_pairs
    default), so every frame is the anchor view of some edge: the alignment
    needs each frame's canonical (own-frame) pointmap."""
    pairs = []
    for i in range(n_frames):
        for k in range(winsize):
            j = i + 2**k
            if j < n_frames:
                pairs.append((i, j))
    if symmetric:
        pairs = pairs + [(j, i) for (i, j) in pairs]
    return pairs


def estimate_focal(pts3d: np.ndarray, pp: tuple[float, float]) -> float:
    """Weiszfeld-style focal from a canonical pointmap (points in their own
    camera frame): the median of (u - cx) * z / x and (v - cy) * z / y."""
    H, W = pts3d.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W]
    u = xs - pp[0]
    v = ys - pp[1]
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    fx = u * z / np.where(np.abs(x) > 1e-6, x, np.nan)
    fy = v * z / np.where(np.abs(y) > 1e-6, y, np.nan)
    cands = np.concatenate([fx.ravel(), fy.ravel()])
    cands = cands[np.isfinite(cands) & (cands > 0)]
    return float(np.median(cands)) if cands.size else float(W)


def _edge_relative_pose(pts_j_in_i, pts_j_self, conf, n_sample=4096, rng=None):
    """Similarity transform mapping frame-j canonical points into frame i."""
    if rng is None:
        rng = np.random.default_rng(0)
    H, W = conf.shape[:2]
    flat = rng.choice(H * W, size=min(n_sample, H * W), replace=False,
                      p=(conf.ravel() / conf.sum()))
    src = pts_j_self.reshape(-1, 3)[flat]
    dst = pts_j_in_i.reshape(-1, 3)[flat]
    return umeyama_alignment(src, dst, with_scale=True)


def cosine_decay(lr: float, steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, steps) at step `count` (alpha 0)."""
    c = min(count, steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / steps))


def _quat_to_R(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y*y + z*z), 2 * (x*y - z*w), 2 * (x*z + y*w)], -1),
        torch.stack([2 * (x*y + z*w), 1 - 2 * (x*x + z*z), 2 * (y*z - x*w)], -1),
        torch.stack([2 * (x*z - y*w), 2 * (y*z + x*w), 1 - 2 * (x*x + y*y)], -1),
    ], -2)


def _align_loss(poses, scales, ei, ej, src, dst, cw):
    def world(pts, fidx):
        R = _quat_to_R(poses[fidx, :4])
        s = torch.exp(scales[fidx])[:, None, None]
        return torch.einsum("eab,esb->esa", R, pts * s) + poses[fidx, 4:][:, None, :]

    d = world(src, ej) - world(dst, ei)
    return torch.sum(cw * torch.sum(d * d, -1)) / torch.sum(cw)


def _refine(pose_params, log_scales, ei, ej, src, dst, cw, lr: float, t_scale: float,
            steps: int, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam over per-frame pose (quaternion xyzw + translation, cam2world)
    and log depth-scales; tensors on one device. src: (E, S, 3) canonical
    frame-j points; dst: (E, S, 3) the same points as predicted in frame i.
    Loss: conf-weighted L2 of their world-frame disagreement.

    Each step, as the JAX package's jitted loop: the gradient of frame 0's
    pose is zeroed (rigid gauge), Adam's update (optax.adam: bias-corrected
    moments, eps outside the sqrt, lr cosine-decayed to 0 over `steps`) is
    scaled per group (rotations and log-scales x ROT_SCALE, translations x
    t_scale, the median edge baseline), and the global scale gauge is reset
    (log-scales re-centred, translations rescaled by exp(-mean)). Returns
    (pose_params, log_scales, loss at the result)."""
    poses, scales = pose_params.clone(), log_scales.clone()
    m = [torch.zeros_like(poses), torch.zeros_like(scales)]
    v = [torch.zeros_like(poses), torch.zeros_like(scales)]
    group = torch.full_like(poses[0], t_scale)
    group[:4] = ROT_SCALE
    for t in range(steps):
        poses.requires_grad_(True)
        scales.requires_grad_(True)
        gp, gs = torch.autograd.grad(_align_loss(poses, scales, ei, ej, src, dst, cw),
                                     (poses, scales))
        poses, scales = poses.detach(), scales.detach()
        gp[0] = 0.0
        step = -cosine_decay(lr, steps, t)
        bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
        ups = []
        for k, g in enumerate((gp, gs)):
            m[k] = (1 - b1) * g + b1 * m[k]
            v[k] = (1 - b2) * (g * g) + b2 * v[k]
            ups.append(step * ((m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)))
        poses = poses + ups[0] * group
        scales = scales + ups[1] * ROT_SCALE
        mu = torch.mean(scales)
        scales = scales - mu
        poses = torch.cat([poses[:, :4], poses[:, 4:] * torch.exp(-mu)], 1)
    with torch.no_grad():
        loss = _align_loss(poses, scales, ei, ej, src, dst, cw)
    return poses, scales, loss


def global_align(
    edge_preds: dict,
    n_frames: int,
    image_hw: tuple[int, int],
    n_sample: int = 1024,
    lr1: float = 0.07,
    steps1: int = 500,
    lr2: float = 0.014,
    steps2: int = 200,
    seed: int = 0,
    collect_timings: bool = False,
    device=None,
):
    """edge_preds: {(i, j): (out_i, out_j)}, the two-view model's outputs
    for the pair as NumPy arrays (pts3d (H, W, 3) + conf (H, W, 1); out_i's
    points are frame i's canonical ones, out_j's are frame j's content in
    frame i's coordinates). The refinement runs on `device` (default: the
    card).

    Returns a dict with poses_c2w (T, 4, 4), depths (T, H, W), focal, pp
    and final_loss; collect_timings adds "timings": the host assembly's
    seconds, each refinement stage's seconds and its ms per Adam step."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    timings = {}
    rng = np.random.default_rng(seed)
    H, W = image_hw
    pairs = sorted(edge_preds.keys())

    # canonical per-frame pointmaps: averaged over the edges the frame anchors
    canon = [None] * n_frames
    for (i, j), (oi, oj) in edge_preds.items():
        p = np.asarray(oi["pts3d"])
        canon[i] = p if canon[i] is None else (canon[i] + p) / 2
    missing = [f for f in range(n_frames) if canon[f] is None]
    if missing:
        raise ValueError(
            f"frames {missing} never appear as an anchor view — use a "
            "symmetric pair graph (make_pairs_logwin(symmetric=True))"
        )

    # per-edge relative similarity + chain init
    rel = {}
    for (i, j), (oi, oj) in edge_preds.items():
        conf = np.asarray(oj["conf"])[..., 0]
        rel[(i, j)] = _edge_relative_pose(np.asarray(oj["pts3d"]), canon[j], conf, rng=rng)

    poses = [None] * n_frames
    scales = np.zeros(n_frames)
    poses[0] = np.eye(4)
    for f in range(1, n_frames):
        # prefer the shortest edge connecting f to an already-placed frame
        for i in range(f - 1, -1, -1):
            if (i, f) in rel and poses[i] is not None:
                s, R, t = rel[(i, f)]
                T = np.eye(4)
                T[:3, :3] = R
                T[:3, 3] = t
                poses[f] = poses[i] @ T
                scales[f] = scales[i] + np.log(max(s, 1e-6))
                break
            if (f, i) in rel and poses[i] is not None:
                s, R, t = rel[(f, i)]
                T = np.eye(4)
                T[:3, :3] = R
                T[:3, 3] = t
                poses[f] = poses[i] @ np.linalg.inv(T)
                scales[f] = scales[i] - np.log(max(s, 1e-6))
                break
        if poses[f] is None:
            poses[f] = poses[f - 1].copy()
            scales[f] = scales[f - 1]

    # edge samples for the refinement
    E, S = len(pairs), n_sample
    src = np.zeros((E, S, 3), np.float32)
    dst = np.zeros((E, S, 3), np.float32)
    cw = np.zeros((E, S), np.float32)
    ei = np.zeros(E, np.int64)
    ej = np.zeros(E, np.int64)
    for e, (i, j) in enumerate(pairs):
        oi, oj = edge_preds[(i, j)]
        conf = np.asarray(oj["conf"])[..., 0].ravel()
        sel = rng.choice(H * W, size=min(S, H * W), replace=False, p=conf / conf.sum())
        src[e, : len(sel)] = canon[j].reshape(-1, 3)[sel]
        dst[e, : len(sel)] = np.asarray(oj["pts3d"]).reshape(-1, 3)[sel]
        cw[e, : len(sel)] = conf[sel]
        ei[e], ej[e] = i, j

    from scipy.spatial.transform import Rotation as _R

    quats = _R.from_matrix(np.stack([p[:3, :3] for p in poses])).as_quat()
    trans = np.stack([p[:3, 3] for p in poses])
    # translation step unit: the median edge baseline of the init, floored
    # by a fraction of the scene's point norm so a static camera still
    # refines
    base = np.linalg.norm(trans[ei] - trans[ej], axis=1)
    scene_norm = float(np.median(np.linalg.norm(dst, axis=-1)))
    t_scale = max(float(np.median(base)), 0.02 * scene_norm, 1e-6)
    # the JAX package passes it as a float32 array: round it the same way
    t_scale = float(np.float32(t_scale))

    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    pose_params = as_t(np.concatenate([quats, trans], axis=1))
    log_scales = as_t(scales)
    edge = (as_t(ei, torch.int64), as_t(ej, torch.int64), as_t(src), as_t(dst), as_t(cw))
    if collect_timings:
        timings["host_assembly_sec"] = time.perf_counter() - t_start
    stage_secs = []
    final_loss = None
    for lr, steps in ((lr1, steps1), (lr2, steps2)):
        t0 = time.perf_counter()
        lr = float(np.float32(lr))
        pose_params, log_scales, final_loss = _refine(pose_params, log_scales, *edge,
                                                      lr, t_scale, steps)
        if collect_timings:
            final_loss.item()  # waits for the stage's last step
            stage_secs.append(time.perf_counter() - t0)
    if collect_timings:
        timings["refine_stage_secs"] = stage_secs
        timings["ms_per_step"] = 1e3 * sum(stage_secs) / max(steps1 + steps2, 1)

    # outputs
    pose_params = pose_params.cpu().numpy()
    log_scales = log_scales.cpu().numpy()
    poses_c2w = []
    for f in range(n_frames):
        q = pose_params[f, :4]
        q = q / np.linalg.norm(q)
        T = np.eye(4)
        T[:3, :3] = _R.from_quat(q).as_matrix()
        T[:3, 3] = pose_params[f, 4:]
        poses_c2w.append(T)
    poses_c2w = np.stack(poses_c2w)

    depths = np.stack([canon[f][..., 2] * np.exp(log_scales[f]) for f in range(n_frames)])
    pp = (W / 2.0, H / 2.0)
    focals = [estimate_focal(canon[f], pp) for f in range(n_frames)]
    out = {
        "poses_c2w": poses_c2w,
        "depths": depths.astype(np.float32),
        "focal": float(np.median(focals)),
        "pp": pp,
        "final_loss": float(final_loss),
    }
    if collect_timings:
        out["timings"] = timings
    return out
