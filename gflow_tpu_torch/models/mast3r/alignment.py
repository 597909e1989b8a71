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
equal to ``optax.adam`` under ``optax.cosine_decay_schedule``;
``torch.optim.Adam`` cannot express its per-group update scaling) on the
caller's device, as the JAX package's jitted ``fori_loop`` runs it
compiled: its state lives in fixed buffers (``_RefineBuffers``: poses,
log-scales, both Adam moments, the step counter, the stage's lr and step
count, the edges), the cosine lr and the bias corrections are computed on
the device from the counter, and on a CUDA device ``CHUNK`` steps replay
as one CUDA graph (``opt.graphs``), recorded once per (T, E, S), device
and recording context and shared by both stages (the tail of a step count
that ``CHUNK`` does not divide is a graph of its own length). On the CPU
and inside ``opt.graphs.disable_graphs()`` the same steps run eagerly.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ... import resolve_device
from ...eval.camera_eval import umeyama_alignment
from ...opt import graphs

ROT_SCALE = 0.05  # update scale of rotations and log-scales (see _refine)
CHUNK = 20  # Adam steps per CUDA graph: divides both stages' 500 and 200
# the refinement's graphs, one entry per (T, E, S), device and recording
# context (the JAX package's jit cache of _refine keys on shapes and steps)
REFINE_GRAPHS = graphs.GraphCache(maxsize=8)


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


class _RefineBuffers(graphs.Buffers):
    """The refinement's state at fixed addresses: what the loop carries
    (``CARRIED``: poses (T, 7), log-scales (T,), Adam's moments of both and
    the step counter ``t``, a 0-d int64) and its inputs (the stage's lr and
    step count as 0-d float64, the per-column update scale ``group`` (7,),
    the edges). Every step updates them in place, eager or replayed."""

    CARRIED = ("poses", "scales", "m_p", "v_p", "m_s", "v_s", "t")

    @classmethod
    def of(cls, poses, scales, edges, dev) -> "_RefineBuffers":
        z = lambda x: torch.zeros_like(x, device=dev)
        ei, ej, src, dst, cw = (x.to(dev, copy=True) for x in edges)
        f64 = lambda: torch.zeros((), dtype=torch.float64, device=dev)
        return cls(poses=z(poses), scales=z(scales), m_p=z(poses), v_p=z(poses),
                   m_s=z(scales), v_s=z(scales), t=torch.zeros((), dtype=torch.int64, device=dev),
                   lr=f64(), steps=f64(), group=z(poses[0]), ei=ei, ej=ej, src=src, dst=dst,
                   cw=cw)

    def load(self, poses, scales, edges, lr: float, t_scale: float, steps: int) -> None:
        """Start a stage: the parameters and edges copied in, the moments and
        the counter at zero, the stage's lr, step count and update scales."""
        for dst, src in zip((self.poses, self.scales, self.ei, self.ej, self.src, self.dst,
                             self.cw), (poses, scales, *edges)):
            dst.copy_(src)
        for x in (self.m_p, self.v_p, self.m_s, self.v_s, self.t):
            x.zero_()
        self.lr.fill_(lr)
        self.steps.fill_(max(steps, 1))
        self.group.fill_(t_scale)
        self.group.narrow(0, 0, 4).fill_(ROT_SCALE)


def lr_and_bias(t, lr, steps, b1: float = 0.9, b2: float = 0.999):
    """Step t's (0-d int64 tensor, counted from 0) update factor -lr_t and
    Adam's bias corrections 1 - b^(t+1), on t's device in float64 (the
    host's arithmetic: ``-cosine_decay(lr, steps, t)`` and Python's
    ``1 - b ** (t + 1)``), rounded to float32 as the eager loop's Python
    numbers were. lr, steps: 0-d float64 tensors."""
    c = torch.minimum(t.to(torch.float64), steps)
    lr_t = lr * 0.5 * (1.0 + torch.cos(math.pi * c / steps))
    n = (t + 1).to(torch.float64)
    return ((-lr_t).float(), (1.0 - torch.pow(b1, n)).float(),
            (1.0 - torch.pow(b2, n)).float())


def _adam_steps(buf: _RefineBuffers, n: int, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """n steps of the refinement in place on `buf` (see _refine)."""
    edges = (buf.ei, buf.ej, buf.src, buf.dst, buf.cw)
    for _ in range(n):
        with torch.enable_grad():
            poses = buf.poses.detach().requires_grad_()
            scales = buf.scales.detach().requires_grad_()
            gp, gs = torch.autograd.grad(_align_loss(poses, scales, *edges), (poses, scales))
        gp.narrow(0, 0, 1).zero_()  # anchor frame 0's pose (rigid gauge)
        step, bc1, bc2 = lr_and_bias(buf.t, buf.lr, buf.steps, b1, b2)
        ups = []
        for g, m, v in ((gp, buf.m_p, buf.v_p), (gs, buf.m_s, buf.v_s)):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            ups.append(step * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
        new_poses = buf.poses + ups[0] * buf.group
        scales = buf.scales + ups[1] * ROT_SCALE
        mu = torch.mean(scales)
        buf.scales.copy_(scales - mu)
        buf.poses.copy_(torch.cat([new_poses[:, :4], new_poses[:, 4:] * torch.exp(-mu)], 1))
        buf.t += 1
    return {}


def _final_loss(buf: _RefineBuffers):
    with torch.no_grad():
        return {"loss": _align_loss(buf.poses, buf.scales, buf.ei, buf.ej, buf.src, buf.dst,
                                    buf.cw)}


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
    (log-scales re-centred, translations rescaled by exp(-mean)). On a CUDA
    device the steps replay as CUDA graphs of CHUNK steps (module
    docstring); a capture or replay that fails raises. Returns
    (pose_params, log_scales, loss at the result)."""
    dev = pose_params.device
    edges = (ei, ej, src, dst, cw)
    if graphs.graphed(dev):
        key = graphs.graph_key(("refine", pose_params.shape[0], *src.shape[:2]), dev)
        run = REFINE_GRAPHS.entry(key, lambda: _RefineBuffers.of(pose_params, log_scales, edges,
                                                                 dev), dev)
        checked = graphs.sync_check(dev)
    else:
        run = graphs.Eager(_RefineBuffers.of(pose_params, log_scales, edges, dev))
        checked = contextlib.nullcontext()
    run.buffers.load(pose_params, log_scales, edges, lr, t_scale, steps)

    def chunk(n):
        return lambda b: _adam_steps(b, n, b1, b2, eps)

    with checked:
        for n in [CHUNK] * (steps // CHUNK) + ([steps % CHUNK] if steps % CHUNK else []):
            run(f"adam{n}", chunk(n))
        loss = run("loss", _final_loss)["loss"]
    buf = run.buffers
    return buf.poses.clone(), buf.scales.clone(), loss.clone()


class AlignSetup(NamedTuple):
    """align_setup's result: the canonical pointmaps (NumPy), the refined
    leaves' initial values and the edge samples on the device, the
    translation step unit, the image size and the timings so far."""
    canon: list
    pose_params: torch.Tensor
    log_scales: torch.Tensor
    edges: tuple
    t_scale: float
    image_hw: tuple
    timings: dict


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
    seconds, each refinement stage's seconds and its ms per Adam step.

    Its three steps, align_setup (the host's NumPy set-up), refine_poses
    (the refinement and its result's pull to the host) and align_outputs
    (the host's outputs), are callable apart, for a caller that times
    each."""
    setup = align_setup(edge_preds, n_frames, image_hw, n_sample, seed, device)
    out = align_outputs(setup, *refine_poses(setup, lr1, steps1, lr2, steps2,
                                             collect_timings))
    if collect_timings:
        out["timings"] = setup.timings
    return out


def refine_poses(setup: AlignSetup, lr1: float = 0.07, steps1: int = 500, lr2: float = 0.014,
                 steps2: int = 200, collect_timings: bool = False):
    """The two Adam stages of the refinement from `setup`, then their
    result pulled to the host (which waits for the card): (pose_params,
    log_scales) as NumPy arrays and the final loss. collect_timings
    waits for each stage's last step and writes its seconds and the ms per
    step into setup.timings."""
    pose_params, log_scales = setup.pose_params, setup.log_scales
    stage_secs = []
    for lr, steps in ((lr1, steps1), (lr2, steps2)):
        t0 = time.perf_counter()
        lr = float(np.float32(lr))
        pose_params, log_scales, final_loss = _refine(pose_params, log_scales, *setup.edges,
                                                      lr, setup.t_scale, steps)
        if collect_timings:
            final_loss.item()  # waits for the stage's last step
            stage_secs.append(time.perf_counter() - t0)
    if collect_timings:
        setup.timings["refine_stage_secs"] = stage_secs
        setup.timings["ms_per_step"] = 1e3 * sum(stage_secs) / max(steps1 + steps2, 1)
    return pose_params.cpu().numpy(), log_scales.cpu().numpy(), float(final_loss)


def align_setup(edge_preds: dict, n_frames: int, image_hw: tuple[int, int],
                n_sample: int = 1024, seed: int = 0, device=None) -> AlignSetup:
    """global_align's host assembly: the canonical pointmaps, the chained
    initial poses and scales, the edge samples and the translation step
    unit, on the device."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
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
    return AlignSetup(canon, pose_params, log_scales, edge, t_scale, image_hw,
                      {"host_assembly_sec": time.perf_counter() - t_start})


def align_outputs(setup: AlignSetup, pose_params, log_scales, final_loss: float) -> dict:
    """global_align's outputs from refine_poses' refined poses and
    log-scales (NumPy): cam2world matrices, scaled depths, focal and pp."""
    from scipy.spatial.transform import Rotation as _R

    canon = setup.canon
    H, W = setup.image_hw
    n_frames = len(canon)
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
    return {
        "poses_c2w": poses_c2w,
        "depths": depths.astype(np.float32),
        "focal": float(np.median(focals)),
        "pp": pp,
        "final_loss": final_loss,
    }
