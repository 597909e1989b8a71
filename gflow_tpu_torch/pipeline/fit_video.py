"""fit_video: the end-to-end entry point.

Counterpart of ``gflow_tpu/pipeline/fit_video.py`` (the original's
gflow/fit_video.py:16-410): frame-0 init and fit, then per frame an
optional camera-only stage and a full stage, trajectory query selection
over the still/move segmentation, 13 diagnostic videos, trajectory
pickles and TrajVisualizer overlays, written to the trainer's log
directory, which ``gflow_tpu.eval.benchmark`` reads. Runs on ``cuda``
unless the caller passes ``device="cpu"``; ``shard_devices=N`` composites
every stage in N bands of tile rows, one per device (N cards, or N bands
on the CPU with ``device="cpu"``). CLI:
``python -m gflow_tpu_torch.cli.fit_video``.
"""
from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import io as gio
from ..utils.profiling import Telemetry
from ..utils.tracking import find_closest_point, process_occu, process_traj_to_tracks
from ..viz.colormap import print_color
from ..viz.traj_visualizer import TrajVisualizer
from ..viz.video import save_video
from .trainer import GFlowTrainer


def main(
    num_points: int = 1000,
    sequence_path: Optional[Path] = Path("./data/davis/beauty_0/beauty_0"),
    iterations_first: int = 10,
    iterations_after: int = 100,
    lr: float = 0.01,
    lr_camera: float = 0.01,
    lr_after: float = 1e-3,
    lr_camera_after: float = 1e-3,
    lambda_rgb: float = 1.0,
    lambda_depth: float = 0.0,
    lambda_still: float = 0.0,
    lambda_scale: float = 0.0,
    lambda_flow: float = 0.0,
    background: str = "black",
    camera_first: bool = False,
    iterations_camera: int = 10,
    frame_start: int = 0,
    frame_range: int = -1,
    densify_times: int = 1,
    densify_interval: int = 0,
    densify_times_after: int = 1,
    densify_interval_after: int = 0,
    lambda_var: float = 1e-7,
    skip_interval: int = 1,
    resize: Optional[int] = None,
    blur: bool = False,
    depth_scale: float = 1.0,
    depth_offset: float = 0.0,
    traj_num: int = 0,
    traj_offset: int = 0,
    logs_suffix: str = "logs",
    common_logs: bool = True,
    load_extr: bool = True,
    densify_occ_percent: float = 1.0,
    densify_err_thre: float = 1e-2,
    densify_err_percent: float = 1.0,
    seed: int = 0,
    shard_devices: int = 0,
    rebin_every: int = 1,
    device: Optional[str] = None,
):
    # the tile-band fitting mode: re-enter under a ("tile",) mesh of
    # shard_devices devices; every stage's RenderConfig.for_scene then
    # composites in one band of tile rows per device (parallel/mesh.py)
    if shard_devices:
        kwargs = dict(locals())
        kwargs["shard_devices"] = 0
        from ..parallel.mesh import fitting_mesh, use_mesh

        with use_mesh(fitting_mesh(shard_devices, device)):
            return main(**kwargs)

    files = gio.list_sequence_files(
        sequence_path, frame_start=frame_start, frame_range=frame_range,
        skip_interval=skip_interval,
    )
    img_paths = files["images"]
    if not img_paths:
        raise FileNotFoundError(f"no frames found under {sequence_path}")

    focal, pp, extr_list = gio.read_camera(files["cameras"])
    move_masks = [gio.read_mask(p, resize=resize) for p in files["move_masks"]]
    mask_exist = len(files["masks"]) > 0

    start_time = time.time()
    telemetry = Telemetry()
    collect = {
        k: []
        for k in (
            "seq", "center_seq", "depth_seq", "opt", "center_opt", "depth_opt",
            "still_seq", "still_center_seq", "move_seq", "move_center_seq",
            "traj", "traj_upon", "move_seg",
        )
    }
    sequence_traj = []
    sequence_traj_occlusion = []

    save_name0 = os.path.basename(str(img_paths[0])).split(".")[0]
    with telemetry.phase("host/init"):
        gt_image0 = gio.load_image(img_paths[0], resize=resize, blur=blur)
        gt_depth0 = gio.read_depth(
            files["depths"][0], resize=resize, depth_scale=1.0,
            depth_offset=depth_offset
        )
        trainer = GFlowTrainer(
            gt_image=gt_image0, gt_depth=gt_depth0, num_points=num_points,
            background=background, sequence_path=sequence_path,
            logs_suffix=logs_suffix, common_logs=common_logs, seed=seed,
            rebin_every=rebin_every, device=device,
        )
        trainer.telemetry = telemetry  # device/host phase attribution
        trainer.load_camera(focal=focal, pp=pp)
        if load_extr:
            trainer.load_camera(extr=extr_list[0])
        trainer.init_gaussians_from_image(gt_image0, gt_depth0,
                                          num_points=num_points)

    with telemetry.phase("frame0_fit"):
        out = trainer.train(
            iterations=iterations_first, lr=lr, lr_camera=lr_camera,
            save_imgs=True, save_videos=True, save_ckpt=True,
            ckpt_name=save_name0,
            lambda_rgb=lambda_rgb, lambda_depth=lambda_depth,
            lambda_var=lambda_var,
            lambda_scale=lambda_scale, densify_times=densify_times,
            densify_interval=densify_interval,
            move_mask=move_masks[0] if move_masks else None,
            densify_occ_percent=densify_occ_percent,
            densify_err_thre=densify_err_thre,
            densify_err_percent=densify_err_percent,
        )
    telemetry.count_frame(iterations_first)
    _collect_stage(collect, out, first=True)

    if mask_exist:
        mask0 = gio.read_mask(files["masks"][0], resize=resize)
        trainer.init_mask_prompt_pts(mask0, ckpt_name=save_name0)

    # ---- trajectory query selection (fit_video.py:163-223) ----
    traj_index, split_interval, n_still_traj, closest_move = [], None, 0, None
    if traj_num:
        with telemetry.phase("host/traj_select"):
            (traj_index, split_interval, n_still_traj,
             closest_move) = _select_traj_queries(trainer)
        with telemetry.phase("host/traj_eval"):
            _eval_traj(trainer, traj_index, split_interval, collect,
                       sequence_traj, sequence_traj_occlusion)

    # ---- per-frame loop ----
    n_frames = len(img_paths) - 1
    for i, img_path in enumerate(img_paths[1:]):
        save_name = os.path.basename(str(img_path)).split(".")[0]
        print_color(f"[{i+1}/{n_frames}] fitting {img_path}")
        with telemetry.phase("host/gt_io"):
            trainer.set_gt_image(
                gio.load_image(img_path, resize=resize, blur=blur))
            trainer.set_gt_depth(
                gio.read_depth(files["depths"][i + 1], resize=resize,
                               depth_scale=1.0, depth_offset=depth_offset)
            )
            occ_mask = (
                gio.load_image(files["occs"][i], resize=resize)[..., 0]
                if i < len(files["occs"]) else None
            )
            trainer.set_gt_flow(
                gio.read_flow(files["flows"][i], resize=resize, blur=blur))
            if load_extr and i + 1 < len(extr_list):
                trainer.load_camera(extr=extr_list[i + 1])
            mm = move_masks[i + 1] if i + 1 < len(move_masks) else None

        if camera_first:
            print_color(f"[{i+1}/{n_frames}] fitting camera-only first ......")
            with telemetry.phase("camera_stage"):
                out = trainer.train(
                    iterations=iterations_camera, lr_camera=lr_camera_after,
                    save_imgs=True, save_ckpt=True, ckpt_name=save_name,
                    lambda_rgb=lambda_rgb, lambda_depth=lambda_depth,
                    lambda_var=0.0, lambda_still=0.0, lambda_flow=lambda_flow,
                    camera_only=True, move_mask=mm,
                    densify_occ_percent=densify_occ_percent,
                    densify_err_thre=densify_err_thre,
                    densify_err_percent=densify_err_percent,
                )
            for k_src, k_dst in (("frames", "opt"), ("frames_center", "center_opt"),
                                 ("frames_depth", "depth_opt")):
                collect[k_dst].append(out[k_src])  # chunk; see _collect_stage

        if iterations_after > 0:
            print_color(f"[{i+1}/{n_frames}] Optimize all ......")
            with telemetry.phase("full_stage"):
                out = trainer.train(
                    iterations=iterations_after, lr=lr_after, lr_camera=0.0,
                    save_imgs=True, save_ckpt=True, ckpt_name=save_name,
                    lambda_rgb=lambda_rgb, lambda_depth=lambda_depth,
                    lambda_var=lambda_var, lambda_still=lambda_still,
                    lambda_scale=lambda_scale, lambda_flow=lambda_flow,
                    densify_times=densify_times_after,
                    densify_interval=densify_interval_after,
                    mask=occ_mask, move_mask=mm,
                    densify_occ_percent=densify_occ_percent,
                    densify_err_thre=densify_err_thre,
                    densify_err_percent=densify_err_percent,
                )
        telemetry.count_frame(iterations_camera * int(camera_first)
                              + iterations_after)

        with telemetry.phase("host/attr_check"):
            # reduced on the device: two scalars and n_alive leave it
            sc = trainer.get_attribute("scale")
            sc_max, sc_min, npts = torch.stack(
                [sc.max(), sc.min(), trainer.state.n_alive.float()]).cpu().tolist()
            print_color(
                f"[check] scales max/min: {float(sc_max):.6f} "
                f"{float(sc_min):.6f} | points: {int(npts)}"
            )
            _collect_stage(collect, out, first=False)
        if traj_num:
            with telemetry.phase("host/traj_eval"):
                _eval_traj(trainer, traj_index, split_interval, collect,
                           sequence_traj, sequence_traj_occlusion)

    total_min = (time.time() - start_time) / 60

    # ---- videos + pickles (fit_video.py:357-392) ----
    names = [
        ("sequence", "seq", 5), ("sequence_center", "center_seq", 5),
        ("sequence_depth", "depth_seq", 5), ("sequence_optimize", "opt", 30),
        ("sequence_center_optimize", "center_opt", 30),
        ("sequence_depth_optimize", "depth_opt", 30),
        ("sequence_still", "still_seq", 5),
        ("sequence_still_center", "still_center_seq", 5),
        ("sequence_move", "move_seq", 5),
        ("sequence_move_center", "move_center_seq", 5),
        ("sequence_move_seg", "move_seg", 5),
        ("sequence_traj", "traj", 5), ("sequence_traj_upon", "traj_upon", 5),
    ]
    with telemetry.phase("host/finalize"):
        # expand the chunked optimize-video lists
        chunked = {"opt", "center_opt", "depth_opt"}
        for key in chunked:
            collect[key] = [np.asarray(f) for chunk in collect[key]
                            for f in chunk]
        for _, key, _ in names:
            if key not in chunked:
                collect[key] = [np.asarray(f) for f in collect[key]]

        for name, key, fps in names:
            save_video(os.path.join(trainer.dir, f"{name}.mp4"),
                       collect[key], fps)

        with open(os.path.join(trainer.dir, "sequence_traj.pkl"), "wb") as f:
            pickle.dump(sequence_traj, f)
        with open(os.path.join(trainer.dir, "frames_sequence.pkl"), "wb") as f:
            pickle.dump(collect["seq"], f)
        with open(os.path.join(trainer.dir,
                               "sequence_traj_occlusion.pkl"), "wb") as f:
            pickle.dump(sequence_traj_occlusion, f)

    if traj_num and sequence_traj:
        with telemetry.phase("host/traj_vis"):
            video = np.stack(collect["seq"]).transpose(
                0, 3, 1, 2)[None].astype(np.float32)
            tracks = process_traj_to_tracks(sequence_traj)
            occl = process_occu(sequence_traj_occlusion, tracks)
            tv = TrajVisualizer(save_dir=trainer.dir, pad_value=0,
                                linewidth=2, fps=5, show_first_frame=2)
            tv.visualize(video=video, tracks=tracks, occulasions=occl,
                         filename="sequence_traj_vis",
                         still_length=n_still_traj)
            if n_still_traj:
                tv.visualize(video=video, tracks=tracks[:, :, :n_still_traj],
                             occulasions=occl[:, :, :n_still_traj],
                             filename="sequence_traj_vis_still")
            if closest_move is not None and len(closest_move):
                tv.visualize(
                    video=video, tracks=tracks[:, :, -len(closest_move):],
                    occulasions=occl[:, :, -len(closest_move):],
                    filename="sequence_traj_vis_move")

    # drain the background writer before declaring the run done — readers
    # (benchmark, tests) expect every submitted PNG/video on disk
    with telemetry.phase("host/io_flush"):
        from ..utils.bgwriter import flush_writes

        flush_writes()

    telemetry.gauge("tile_overflow_last",
                    getattr(trainer, "last_tile_overflow", None))
    telemetry.gauge("t_final_overflow_last",
                    getattr(trainer, "last_t_final", None))
    telemetry.gauge("k_escalations", getattr(trainer, "k_escalations", []))
    telemetry.gauge("final_max_per_tile",
                    trainer.render_config.max_per_tile)
    telemetry.gauge("device", torch.cuda.get_device_name(trainer.device)
                    if trainer.device.type == "cuda" else trainer.device.type)
    telemetry.dump(os.path.join(trainer.dir, "telemetry.json"))
    print_color(f"Total time: {total_min:.2f} mins", color="green")
    print_color(
        f"telemetry: {telemetry.summary()['sec_per_frame']}s/frame, "
        f"{telemetry.summary()['opt_steps_per_sec']} steps/s", color="cyan")
    return trainer


def _collect_stage(collect, out, first: bool):
    # the optimize videos keep each stage's snapshots as one chunk
    collect["opt"].append(out["frames"])
    collect["center_opt"].append(out["frames_center"])
    collect["depth_opt"].append(out["frames_depth"])
    if out["frames"]:
        collect["seq"].append(out["frames"][-1])
        collect["center_seq"].append(out["frames_center"][-1])
        collect["depth_seq"].append(out["frames_depth"][-1])
    else:
        collect["seq"].append(out["last_rgb"])
    if out.get("move_seg") is not None:
        collect["move_seg"].append(
            np.repeat(out["move_seg"][..., None], 3, axis=-1)
        )
    if out.get("still_rgb") is not None:
        collect["still_seq"].append(out["still_rgb"])
        collect["still_center_seq"].append(out["still_center"])
        collect["move_seq"].append(out["move_rgb"])
        collect["move_center_seq"].append(out["move_center"])


def _select_traj_queries(trainer: GFlowTrainer):
    """Grid queries over the eroded still/move segmentation; nearest rendered
    Gaussian per query (fit_video.py:168-215)."""
    from scipy.ndimage import binary_erosion

    H, W = trainer.H, trainer.W
    move_seg = trainer.move_seg if trainer.move_seg is not None else np.zeros(
        (H, W), np.uint8
    )
    kern = np.ones((10, 10), bool)
    move_er = binary_erosion(move_seg > 0, structure=kern)
    still_er = binary_erosion(~(move_seg > 0), structure=kern)

    stride_still, stride_moving = 50, 15
    sparse = [
        np.array([j, i])
        for i in range(stride_still, H, stride_still)
        for j in range(stride_still, W, stride_still)
        if still_er[i, j]
    ]
    if not sparse:
        sparse = [
            np.array([j, i])
            for i in range(stride_still, H, stride_still)
            for j in range(stride_still, W, stride_still)
        ]
    sparse = np.array(sparse)
    conc = [
        np.array([j, i])
        for i in range(stride_moving, H - stride_moving, stride_moving)
        for j in range(stride_moving, W - stride_moving, stride_moving)
        if move_er[i, j]
    ]
    conc = np.array(conc) if conc else np.zeros((0, 2))

    n = int(trainer.state.last_num)
    uv = trainer.state.last_uv[:n].cpu().numpy()
    still_mask = trainer.state.still_mask[:n].cpu().numpy()
    cs = find_closest_point(uv, sparse)
    closest_still = cs[still_mask[cs]]
    closest_move = None
    if len(conc):
        cm = find_closest_point(uv, conc)
        closest_move = cm[~still_mask[cm]]
        split_interval = len(closest_still)
        closest = np.concatenate([closest_still, closest_move])
    else:
        closest = closest_still
        split_interval = None
    print_color(f"traj queries: {len(closest)} (still {len(closest_still)})")
    return closest.tolist(), split_interval, len(closest_still), closest_move


def _eval_traj(trainer, traj_index, split_interval, collect, sequence_traj,
               sequence_traj_occlusion):
    if not traj_index:
        return
    out_img, _, _, out_traj, out_upon, uv = trainer.eval(
        traj_index=traj_index, line_scale=0.5, point_scale=2.0, alpha=0.8,
        split_interval=split_interval, need_center_depth=False,
        return_query_uv=True,
    )
    collect["traj"].append(out_traj)
    collect["traj_upon"].append(out_upon)
    sequence_traj.append(np.asarray(uv))
    seg = trainer.move_seg if trainer.move_seg is not None else np.zeros(
        (trainer.H, trainer.W), np.uint8
    )
    sequence_traj_occlusion.append(seg)
