"""Benchmark CLI — the reference's four evaluation suites
(gflow/benchmark.py:180-406): reconstruction PSNR/SSIM/LPIPS, TAP-Vid
tracking (OA/AJ/APTS), move-segmentation J/F/J&F, and camera ATE/RPE.

Counterpart of ``gflow_tpu/eval/benchmark.py``. Inputs are a fit_video log
directory (images/, images_seg/, ckpt/*.npz, of either package) and the
source sequence directory with its prior folders. Output: a dict +
<csv_name>.csv in the log dir. SSIM, LPIPS and the tracking suite's renders
run on ``cuda`` unless the caller passes ``device="cpu"``; segmentation and
camera are host-only.
"""
from __future__ import annotations

import glob
import json
import os
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..core import io as gio
from ..utils.tracking import extract_first_visible_points, find_closest_point
from ..viz.colormap import print_color
from .camera_eval import ate_rmse, rpe
from .davis import boundary_f_measure, jaccard_iou
from .metrics import LPIPSAlex, load_lpips_weights, lpips, psnr, ssim_metric
from .tapvid import compute_tapvid_metrics


def eval_reconstruction(log_path, sequence_path, resize=480, device=None):
    """PSNR/SSIM/LPIPS of saved renders vs resized GT
    (gflow/benchmark.py:191-230)."""
    dev = resolve_device(device)
    img_dir = os.path.join(log_path, "images")
    paths = sorted(glob.glob(os.path.join(img_dir, "img_0*.png"))) + sorted(
        glob.glob(os.path.join(img_dir, "img_0*.jpg"))
    )
    weights = load_lpips_weights()
    net = LPIPSAlex(weights).to(dev) if weights is not None else None
    psnrs, ssims, lpipss = [], [], []
    for p in paths:
        img = gio.load_image(p)
        base = os.path.basename(p).split(".")[0].split("_")[-1]
        gt_path = os.path.join(sequence_path, f"{base}.jpg")
        if not os.path.exists(gt_path):
            gt_path = os.path.join(sequence_path, f"{base}.png")
        gt = np.clip(gio.load_image(gt_path, resize=resize), 0, 1)
        if gt.shape != img.shape:
            gt = gio.resize_image(gt, min(img.shape[:2]))[: img.shape[0], : img.shape[1]]
        psnrs.append(psnr(img, gt))
        ssims.append(ssim_metric(img, gt, device=dev))
        if net is not None:
            lpipss.append(lpips(img, gt, net))
    out = {
        "PSNR": float(np.mean(psnrs)) if psnrs else None,
        "SSIM": float(np.mean(ssims)) if ssims else None,
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
    }
    if psnrs and not lpipss:
        # environment-gated, not broken: the graph + weight converter exist
        # and are parity-tested (eval/metrics.py, eval/lpips_convert.py), but
        # no AlexNet/LPIPS weights ship in this environment
        out["LPIPS_note"] = ("weights not available in environment; "
                             "graph + converter implemented and parity-tested")
    return out


def eval_tracking(sequence_path, load_path, background="black", resize=None, device=None):
    """TAP-Vid tracking via per-checkpoint nearest-Gaussian assignment with
    first-frame shift correction; occlusion = |rendered depth at uv - point
    depth| > 0.05 (gflow/benchmark.py:54-178).

    Deliberate fix over the reference: the alpha-blended depth map is
    normalized by the accumulated alpha before thresholding. The blended
    map is sum(d_i*alpha_i*T_i) + bg*T_final — wherever accumulation does
    not saturate (T_final > 0.025 at depth ~2) the raw map is biased low by
    depth*T_final and the reference's 0.05 absolute test flags VISIBLE
    points as occluded (OA 47% on a zero-occlusion scene). Dividing by
    sum(alpha_i*T_i) recovers the expected surface depth the 0.05
    threshold was designed for; on saturated scenes (the reference's
    operating regime) the two are identical.

    The trainer picks its RenderConfig from the first frame
    (``RenderConfig.for_scene`` at 1000 points), whatever the checkpoints
    hold, as the JAX package's does."""
    from ..pipeline.trainer import GFlowTrainer

    ckpt_paths = sorted(glob.glob(os.path.join(load_path, "ckpt", "*.npz")))
    if not ckpt_paths:
        return None, None, None
    pickle_path = os.path.join(str(sequence_path), "tracking.pkl")
    if not os.path.exists(pickle_path):
        return None, None, None
    with open(pickle_path, "rb") as f:
        traj_info = pickle.load(f)
    gt_tracks_norm = traj_info["points"].copy()   # (Q, T, 2) normalized xy
    gt_occluded = traj_info["occluded"].copy()    # (Q, T)

    img_paths = []
    for cp in ckpt_paths:
        base = os.path.basename(cp).split(".")[0]
        for ext in (".png", ".jpg"):
            p = os.path.join(str(sequence_path), base + ext)
            if os.path.exists(p):
                img_paths.append(p)
                break
    gt_image0 = gio.load_image(img_paths[0], resize=resize)
    trainer = GFlowTrainer(gt_image=gt_image0, num_points=1000,
                           background=background, make_logs=False, device=device)
    trainer.load_checkpoint(ckpt_paths[0])
    H, W = trainer.H, trainer.W

    query_points = extract_first_visible_points(gt_tracks_norm, gt_occluded)
    query_points = query_points.astype(np.float64)
    query_points[:, 1] *= H
    query_points[:, 2] *= W

    Q = query_points.shape[0]
    T = len(ckpt_paths)
    traj_pred = np.zeros((Q, T, 2), np.float32)
    occlusions = np.empty((Q, T))
    queried, closest, first_shift = [], [], []

    for i, cp in enumerate(ckpt_paths):
        trainer.load_checkpoint(cp)
        out = trainer.render_views(("uv", "depth", "depth_map", "acc"))
        n = int(trainer.state.n_alive)
        uv = out["uv"][:n].cpu().numpy()
        acc = out["acc"][..., 0].cpu().numpy()
        depth_map = out["depth_map"][..., 0].cpu().numpy() / np.maximum(acc, 1e-6)

        new_q = np.where(query_points[:, 0] == i)[0].tolist()
        queried.extend(new_q)
        q_xy = query_points[new_q][:, -1:0:-1]  # (n_new, 2) [x, y]
        cl = find_closest_point(uv, q_xy)
        closest.extend(cl.tolist())
        first_shift.extend(q_xy - uv[cl])

        idx = torch.as_tensor(np.asarray(closest, np.int64), device=trainer.device)
        traj_uv, depth_p = trainer.project_points(trainer.params.xyz[idx].cpu().numpy())
        depth_p = depth_p[:, 0]
        traj_pred[queried, i] = traj_uv + np.asarray(first_shift)

        yi = np.clip(np.round(traj_uv[:, 1]).astype(int), 0, H - 1)
        xi = np.clip(np.round(traj_uv[:, 0]).astype(int), 0, W - 1)
        occlusions[queried, i] = np.abs(depth_map[yi, xi] - depth_p) > 0.05

    # TAP-Vid at the 256x256 convention (benchmark.py:168-172)
    gt_tracks = gt_tracks_norm[None, :, :T, :].copy()
    gt_tracks[..., 0] *= 255
    gt_tracks[..., 1] *= 255
    pred = traj_pred[None].copy()
    pred[..., 0] = pred[..., 0] / W * 255
    pred[..., 1] = pred[..., 1] / H * 255
    res = compute_tapvid_metrics(
        query_points[None], gt_occluded[None, :, :T], gt_tracks,
        occlusions[None].astype(bool), pred, "strided",
    )
    return (
        res["occlusion_accuracy"],
        res["average_jaccard"],
        res["average_pts_within_thresh"],
    )


def eval_segmentation(log_path, sequence_path):
    """J/F/J&F of saved move masks vs epipolar masks
    (gflow/benchmark.py:243-285)."""
    seg_dir = os.path.join(log_path, "images_seg")
    paths = sorted(glob.glob(os.path.join(seg_dir, "move_mask_*.png")))
    paths = [p for p in paths if "erode" not in p]
    js, fs, jfs = [], [], []
    for p in paths:
        seg = gio.load_image(p)[..., 0] > 0.5
        base = os.path.basename(p).split(".")[0].split("_")[-1]
        gt_path = os.path.join(str(sequence_path) + "_epipolar", f"{base}_open.png")
        if not os.path.exists(gt_path):
            continue
        gt = gio.load_image(gt_path).mean(axis=-1) > 0.5
        if gt.shape != seg.shape:
            gt = gio.resize_image(gt.astype(np.float32), min(seg.shape[:2])) > 0.5
            gt = gt[: seg.shape[0], : seg.shape[1]]
        j = jaccard_iou(gt, seg)
        f = boundary_f_measure(seg, gt)
        js.append(j)
        fs.append(f)
        jfs.append((j + f) / 2)
    if not js:
        return {"J_zero": None, "F_zero": None, "J&F_zero": None}
    return {
        "J_zero": float(np.mean(js)),
        "F_zero": float(np.mean(fs)),
        "J&F_zero": float(np.mean(jfs)),
    }


def eval_camera(log_path, sequence_path):
    """ATE / RPE of checkpoint extrinsics vs MASt3R poses as pseudo-GT,
    Sim(3)-aligned (gflow/benchmark.py:289-394)."""
    gt_paths = sorted(
        glob.glob(os.path.join(str(sequence_path) + "_camera_mast3r_s2", "*.json"))
    )
    ckpt_paths = sorted(glob.glob(os.path.join(log_path, "ckpt", "*.npz")))
    if not gt_paths or not ckpt_paths:
        return {"ATE": None, "RPE_t": None, "RPE_r": None}
    if len(ckpt_paths) < 0.8 * (len(gt_paths) - 1):
        return {"ATE": None, "RPE_t": None, "RPE_r": None}

    n = min(len(gt_paths), len(ckpt_paths))
    gt_c2w, est_c2w = [], []
    for gp, cp in zip(gt_paths[:n], ckpt_paths[:n]):
        with open(gp) as f:
            pose_w2c = np.asarray(json.load(f)["pose"], np.float64)
        gt_c2w.append(np.linalg.inv(pose_w2c))
        d = np.load(cp)
        extr = np.concatenate([d["extr"], [[0, 0, 0, 1]]], axis=0)
        est_c2w.append(np.linalg.inv(extr))
    gt_c2w = np.stack(gt_c2w)
    est_c2w = np.stack(est_c2w)

    try:
        ate = ate_rmse(gt_c2w[:, :3, 3], est_c2w[:, :3, 3], align=True,
                       correct_scale=True)
        rpe_t, rpe_r = rpe(gt_c2w, est_c2w)
    except np.linalg.LinAlgError:
        print_color(f"Seq {log_path} camera eval not valid", color="red")
        return {"ATE": None, "RPE_t": None, "RPE_r": None}
    return {"ATE": ate, "RPE_t": rpe_t, "RPE_r": rpe_r}


def main(
    log_path: str,
    sequence_path: str,
    csv_name: str = "metrics",
    eval_recon: bool = True,
    eval_track: bool = True,
    eval_seg: bool = True,
    eval_camera_flag: bool = True,
    device: str | None = None,
):
    """The four suites on a fit_video log directory; `device` (default
    cuda) runs SSIM, LPIPS and the tracking renders."""
    dev = resolve_device(device)
    csv_dir = {}
    if eval_recon:
        print_color("Evaluating reconstruction quality (PSNR, SSIM, LPIPS)...")
        csv_dir.update(eval_reconstruction(log_path, sequence_path, device=dev))
    if eval_track:
        print_color("Evaluating tracking quality (OA, AJ, APTS)...")
        oa, aj, apts = eval_tracking(sequence_path, log_path, device=dev)
        csv_dir["Occlusion_Accuracy"] = oa
        csv_dir["Average_Jaccard"] = aj
        csv_dir["Average_PTS_within_threshold"] = apts
    if eval_seg:
        print_color("Evaluating segmentation quality (J, F, J&F)...")
        csv_dir.update(eval_segmentation(log_path, sequence_path))
    if eval_camera_flag:
        print_color("Evaluating trajectory quality (ATE, RPE)...")
        csv_dir.update(eval_camera(log_path, sequence_path))

    with open(os.path.join(log_path, f"{csv_name}.csv"), "w") as f:
        for k, v in csv_dir.items():
            f.write(f"{k},{v}\n")
    for k, v in csv_dir.items():
        print_color(f"{k}: {v}")
    return csv_dir
