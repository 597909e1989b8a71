"""GFlowTrainer: the scene and optimization driver of fit_video.

Counterpart of ``gflow_tpu/pipeline/trainer.py`` (the original GFlow's
SimpleGaussian, gflow/trainer.py:17-955): init from an image, per-frame
optimization stages, still/move bookkeeping and its concave-hull
segmentation, diagnostic renders, trajectory line sets and checkpoints
with the same npz schema and log-directory layout (logs/<timestamp> and a
"0_latest" link).

The device work (rendering, losses, Adam, densify) is
``opt.train.train_stage``; this class does the host side. It runs on
``cuda`` unless the caller passes ``device="cpu"``. On the card each stage
runs as CUDA graphs, kept in the trainer's own ``opt.graphs.GraphCache``
(``self.graphs``, the counterpart of the JAX trainer's ``_compiled_stage``
cache): every frame replays the graphs its stage configuration recorded;
a K escalation or a capacity growth makes a new key. The host-called
device paths are CUDA graphs too, one per static call shape: the
diagnostic views, the trajectory image, ``project_points`` and
``gather_project`` in the trainer's ``forward_graphs`` (the counterparts
of ``_compiled_diag``, ``_compiled_traj_render``, ``_compiled_world2pix``
and ``_compiled_gather_project``, with their cache sizes), and
``render_views`` through ``ops.render.render_jit``. Every stage pulls its
host-side results in one batch (``_host``), and images leave the device
as uint8. Two departures from the JAX package, both its intent: a target
map is uploaded once per ``set_gt_*`` call (the JAX package caches the
upload on the host array's identity), and the trajectory line set's
capacity is fixed at its first append (the JAX package re-raises it on
every eval, so the drop-oldest branch never runs there).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import default_intrinsics, extr_to_pose, pose_to_extr, world2pix
from ..core.io import imwrite
from ..core.scene import activate, activate_inv
from ..ops.render import RenderConfig, quantize_u8, render, render_jit, render_traj
from ..ops.stamp import pieces as stamp_pieces
from ..opt.initialize import init_params_from_image
from ..opt.graphs import ForwardCache, GraphCache
from ..opt.losses import LossWeights
from ..opt.state import Params, Targets, init_frame_state
from ..opt.train import StageConfig, StageDynamics, train_stage
from ..utils.bgwriter import flush_writes, get_writer, writer_backlog, writer_busy_s
from ..utils.hull import FastConcaveHull2D
from ..viz.colormap import apply_float_colormap, print_color

BACKGROUNDS = {"black": 0.0, "white": 1.0, "cyan": 0.33}  # "cyan" is grey 0.33
                                                          # (trainer.py:33-34)


def _host(tree):
    """Every tensor of a (nested) dict as a NumPy array: the stage's one
    batched pull to the host."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _erode(mask_u8: np.ndarray, size: int = 20) -> np.ndarray:
    from scipy.ndimage import binary_erosion

    er = binary_erosion(mask_u8 > 0, structure=np.ones((size, size), bool))
    return (er * 255).astype(np.uint8)


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


# the trainer's host-called device paths as CUDA graphs, with the JAX
# package's cache sizes (gflow_tpu/pipeline/trainer.py:61-155)
FORWARD_GRAPHS = {"diag": 16, "traj": 4, "world2pix": 1, "gather_project": 1}


def _diag(params: Params, n_alive, last_num, still_mask, intr, bg: float, W: int, H: int,
          config: RenderConfig) -> dict:
    """The post-stage diagnostic renders in one call (the counterpart of
    ``_compiled_diag``; trainer.py:627-697): activation, the full scene's
    rgb/center/depth_map_color and the still-only and move-only subsets,
    selected by masking opacity as the original's array slicing selects
    rows (still: i < last_num with still_mask; move: i < last_num
    without), quantized to uint8."""
    C, dev = params.capacity, intr.device
    alive = (torch.arange(C, device=dev) < n_alive)[:, None]
    xyz, scale = params.xyz, torch.abs(params.scale)
    rotate, rgb = activate("rotate", params.rotate), activate("rgb", params.rgb)
    opacity = activate("opacity", params.opacity) * alive
    args = (intr, pose_to_extr(params.pose), bg, W, H)
    out = dict(render(xyz, scale, rotate, opacity, rgb, *args,
                      ("rgb", "center", "depth_map_color"), config, as_uint8=True, device=dev))
    in_prev = torch.arange(C, device=dev) < last_num
    for name, sel in (("still", in_prev & still_mask), ("move", in_prev & ~still_mask)):
        sub = render(xyz, scale, rotate, opacity * sel[:, None], rgb, *args, ("rgb", "center"),
                     config, as_uint8=True, device=dev)
        out[name + "_rgb"], out[name + "_center"] = sub["rgb"], sub["center"]
    return out


def _traj_render(xyz, opacity, rgb, intr, pose, n_actual, bg: float, W: int, H: int,
                 point_num: int, line_scale: float, point_scale: float, config: RenderConfig,
                 as_uint8: bool):
    """The padded trajectory line set drawn from the camera of `pose` (the
    counterpart of ``_compiled_traj_render``): the constant scale and
    rotation columns are made on the device, n_actual is a 0-d tensor."""
    cap, dev = xyz.shape[0], xyz.device
    scale = torch.full((cap, 3), 1e-6, dtype=torch.float32, device=dev)
    rotate = torch.zeros((cap, 4), dtype=torch.float32, device=dev)
    rotate[:, 0] = 1.0
    img = render_traj(xyz, scale, rotate, opacity, rgb, intr, pose_to_extr(pose), bg, W, H,
                      point_num, line_scale, point_scale, config, n_actual, device=dev)
    return quantize_u8(img) if as_uint8 else img


def _world2pix(points, intr, pose):
    return world2pix(points, intr, pose_to_extr(pose))


def _gather_project(xyz, index, intr, pose):
    sel = xyz[index]
    return sel, world2pix(sel, intr, pose_to_extr(pose))[0]


def _gen_line_set(xyz1: np.ndarray, xyz2: np.ndarray, rgb: np.ndarray):
    """Segments between consecutive trajectory positions as point strips;
    returns (line + endpoint xyz, rgb) with the endpoints last
    (gflow/utils/trainer_functions.py:5-40), vectorized over queries."""
    diff = xyz2 - xyz1
    dist = np.linalg.norm(diff, axis=1)
    # as the original: L = max(2, int(dist*100)); L-1 points at t = k/(L-1)
    n_seg = np.maximum(2, (dist * 100).astype(np.int64)) - 1
    max_n = int(n_seg.max()) if len(n_seg) else 1
    ts = np.arange(max_n, dtype=np.float32)[None, :] / np.maximum(n_seg, 1)[:, None]
    valid = np.arange(max_n)[None, :] < n_seg[:, None]
    pts = xyz1[:, None, :] + ts[..., None] * diff[:, None, :]
    cols = np.broadcast_to(rgb[:, None, :], pts.shape)
    return (np.concatenate([pts[valid], xyz2]).astype(np.float32),
            np.concatenate([cols[valid], rgb]).astype(np.float32))


class GFlowTrainer:
    def __init__(
        self,
        gt_image: np.ndarray,                 # (H, W, 3) float [0, 1]
        gt_depth: np.ndarray | None = None,   # (H, W)
        gt_flow: np.ndarray | None = None,
        num_points: int = 100000,
        background: str = "black",
        sequence_path=None,
        logs_suffix: str = "_logs",
        common_logs: bool = True,
        capacity: int | None = None,
        render_config: RenderConfig | None = None,  # None: RenderConfig.for_scene
        seed: int = 0,
        make_logs: bool = True,
        rebin_every: int = 1,  # >1: amortized tile binning (opt.train.StageConfig)
        device=None,
    ):
        self.device = resolve_device(device)
        self.rebin_every = int(rebin_every)
        self.num_points = int(num_points)
        self.H, self.W = np.asarray(gt_image).shape[:2]
        self.bg = BACKGROUNDS.get(background, 0.0)
        self._dev = {}  # target name -> device copy, refreshed by each set_gt_*
        self.gt_depth = self.gt_flow = None
        self.set_gt_image(gt_image)
        if gt_depth is not None:
            self.set_gt_depth(gt_depth)
        if gt_flow is not None:
            self.set_gt_flow(gt_flow)
        if render_config is None:
            render_config = RenderConfig.for_scene(self.W, self.H, self.num_points,
                                                   image=self.gt_image)
        self.render_config = render_config
        self.rng = np.random.default_rng(seed)  # the init, as in the JAX package
        # the densify uniforms
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.graphs = GraphCache()  # the stages' CUDA graphs, per stage configuration
        # the renders and projections' CUDA graphs, per static call shape
        self.forward_graphs = {k: ForwardCache(k, n) for k, n in FORWARD_GRAPHS.items()}
        self._gather_key = self._gather_index = None  # the query set, uploaded once

        if capacity is None:
            # num_points + 50% densify headroom, rounded up to 1024; densify
            # clamps to the free slots and _grow_capacity re-pads on a
            # checkpoint load that outgrows it
            capacity = max(1024, -(-int(self.num_points * 1.5) // 1024) * 1024)
        self.capacity = capacity
        self.intr = default_intrinsics(self.W, self.H, self.device)

        # random init (replaced by init_gaussians_from_image on the real
        # path; trainer.py:79-86), from the same NumPy stream as JAX's
        C, rng = capacity, self.rng
        self.params = Params(*(torch.from_numpy(x).to(self.device) for x in (
            rng.random((C, 3), np.float32) * 2 - 1,
            rng.random((C, 3), np.float32),
            _unit(rng.random((C, 4)).astype(np.float32)),
            np.full((C, 1), float(activate_inv("opacity", torch.tensor(0.99))), np.float32),
            rng.random((C, 3), np.float32),
            np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32),
            np.asarray([1.0, 0.0], np.float32),
        )))
        self.state = init_frame_state(capacity, self.device)._replace(
            n_alive=torch.tensor(min(self.num_points, C), dtype=torch.int32,
                                 device=self.device))
        self.move_seg: np.ndarray | None = None
        self.move_seg_erode: np.ndarray | None = None
        self.propagate_seg: np.ndarray | None = None
        self.mask_prompt_pts: np.ndarray | None = None
        self._traj = None
        self._last_views = None  # the last diagnostic render, reused once by eval()
        self.pose_list = None    # optional per-frame pose list, saved when set
        self.telemetry = None    # optional utils.profiling.Telemetry
        self._writer_mark = None  # (telemetry, writer busy seconds at its last record)
        self._last_num_host = 0  # host mirror of state.last_num
        self.last_t_final = None  # residual transmittance on K-overflowing tiles
        # truncation guardrail (see train()): escalate max_per_tile when the
        # mean residual transmittance on overflowing tiles exceeds this;
        # None disables
        self.k_escalate_threshold: float | None = 0.01
        self.k_escalate_max: int = 192
        self.k_escalations: list = []
        # the first measured stage escalates at k_preseed_fraction * threshold
        self.k_preseed_fraction: float = 0.5
        self._k_seen_first_stage = False

        # log directory + "0_latest" link (trainer.py:89-112)
        self.dir = None
        if make_logs:
            now = datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
            if common_logs:
                logs_path = logs_suffix if logs_suffix else "logs"
            else:
                logs_path = (f"{sequence_path}_{logs_suffix}" if logs_suffix
                             else f"{sequence_path}_logs")
            log_now = os.path.join(logs_path, now)
            os.makedirs(log_now, exist_ok=True)
            latest = os.path.join(logs_path, "0_latest")
            os.makedirs(latest, exist_ok=True)
            for e in Path(latest).iterdir():
                if e.is_symlink() or e.is_file():
                    e.unlink()
            os.symlink(os.path.abspath(log_now), os.path.join(latest, now))
            self.dir = log_now

    # ------------------------------------------------------------------
    # camera
    # ------------------------------------------------------------------

    def get_extr(self) -> torch.Tensor:
        return pose_to_extr(self.params.pose)

    def load_camera(self, focal=None, pp=None, extr=None, scale=None, show=False):
        """(trainer.py:164-183)"""
        if focal is not None or pp is not None:
            self.intr = self.intr.clone()
        if focal is not None:
            self.intr[:2] = float(focal)
        if pp is not None:
            self.intr[2:] = torch.as_tensor(np.asarray(pp, np.float32))
        if extr is not None:
            extr = np.asarray(extr, np.float32)
            t = extr[:3, 3] * (scale if scale is not None else 1.0)
            pose = np.concatenate([extr_to_pose(torch.from_numpy(extr)).numpy()[:4], t])
            self.params = self.params._replace(
                pose=torch.from_numpy(pose.astype(np.float32)).to(self.device))
            self._last_views = None  # the cached diagnostic render is view-stale
        if show:
            print_color(f"[camera] intr: {self.intr.cpu().numpy()}")
            print_color(f"[camera] extr:\n{self.get_extr().cpu().numpy()}")

    # ------------------------------------------------------------------
    # init / gt setters: each call uploads its map once
    # ------------------------------------------------------------------

    def _put(self, name: str, arr: np.ndarray):
        self._dev[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            self.device)

    def set_gt_image(self, img):
        self.gt_image = np.asarray(img, np.float32)
        self._put("image", self.gt_image)

    def set_gt_depth(self, d):
        self.gt_depth = np.asarray(d, np.float32).reshape(self.H, self.W)
        self._put("depth", self.gt_depth[..., None])

    def set_gt_flow(self, f):
        self.gt_flow = np.asarray(f, np.float32)
        self._put("flow", self.gt_flow[..., :2])

    def init_gaussians_from_image(self, gt_image=None, gt_depth=None,
                                  num_points=None, mask=None, drop_to=None):
        """(trainer.py:206-238)"""
        img = self.gt_image if gt_image is None else np.asarray(gt_image, np.float32)
        depth = self.gt_depth if gt_depth is None else np.asarray(gt_depth, np.float32)
        self.set_gt_depth(depth)
        new_params, n = init_params_from_image(
            img, self.gt_depth, num_points or self.num_points, self.capacity,
            self.intr.cpu().numpy(), self.get_extr().cpu().numpy(), mask=mask,
            drop_to=drop_to, rng=self.rng, device=self.device)
        self.params = new_params._replace(pose=self.params.pose,
                                          depth_ab=self.params.depth_ab)
        self.state = self.state._replace(
            n_alive=torch.tensor(n, dtype=torch.int32, device=self.device))
        self._last_views = None
        xyz = self.params.xyz[:n].cpu().numpy()
        print_color(
            f"[init] n={n} x range ({xyz[:,0].min():.3f},{xyz[:,0].max():.3f}) "
            f"y ({xyz[:,1].min():.3f},{xyz[:,1].max():.3f}) "
            f"z ({xyz[:,2].min():.3f},{xyz[:,2].max():.3f})")

    def current_pts_num(self) -> int:
        return int(self.state.n_alive)

    def get_attribute(self, name: str) -> torch.Tensor:
        val = activate(name, getattr(self.params, name))
        if name == "opacity":
            return val * (torch.arange(self.capacity, device=self.device)
                          < self.state.n_alive)[:, None]
        return val

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def _targets(self, move_mask=None, occ_mask=None) -> Targets:
        H, W = self.H, self.W
        if "flow" not in self._dev:
            self._put("flow", np.zeros((H, W, 2), np.float32))
        if "depth" not in self._dev:
            self._put("depth", np.ones((H, W, 1), np.float32))
        mask = lambda m: torch.from_numpy(
            np.zeros((H, W), bool) if m is None else np.asarray(m) > 0).to(self.device)
        return Targets(image=self._dev["image"], depth=self._dev["depth"],
                       flow=self._dev["flow"], move_mask=mask(move_mask),
                       occ_mask=mask(occ_mask))

    def train(
        self,
        iterations=500,
        lr=1e-2,
        lr_camera=0.0,
        lambda_rgb=1.0,
        lambda_depth=0.0,
        lambda_flow=0.0,
        lambda_var=0.0,
        lambda_still=0.0,
        lambda_scale=0.0,
        save_imgs=False,
        save_videos=False,
        save_ckpt=False,
        move_mask=None,
        ckpt_name="ckpt",
        densify_interval=0,
        densify_times=1,
        mask=None,
        camera_only=False,
        densify_occ_percent=0.1,
        densify_err_thre=1e-2,
        densify_err_percent=0.2,
        max_densify=None,
    ):
        """One optimization stage (trainer.py:332-711). Returns a dict:
        frames/frames_center/frames_depth (the training snapshots, empty
        unless save_videos), still/move renders, move_seg, metrics."""
        has_last = self._last_num_host > 0
        tel = self.telemetry
        if tel is not None and (self._writer_mark is None or self._writer_mark[0] is not tel):
            self._writer_mark = (tel, writer_busy_s())
        cfg = StageConfig(
            W=self.W,
            H=self.H,
            iterations=int(iterations),
            camera_only=bool(camera_only),
            propagate=bool(has_last and not camera_only),
            densify_interval=int(densify_interval or 0),
            densify_times=int(densify_times),
            densify_occ=bool(has_last and not camera_only and mask is not None),
            max_densify=int(max_densify or min(self.capacity, 16384)),
            bg=self.bg,
            render=self.render_config,
            snapshot_every=10 if save_videos else 0,
            rebin_every=self.rebin_every,
            # residual-transmittance stats on full stages: they feed the
            # telemetry and the K-escalation guardrail below
            telemetry_t_final=not camera_only,
            # the iteration's pieces stamped on the device, into the telemetry
            stamps=tel is not None,
        )
        dyn = StageDynamics(
            lr=lr, lr_camera=lr_camera,
            weights=LossWeights(rgb=lambda_rgb, depth=lambda_depth, var=lambda_var,
                                scale=lambda_scale, still=lambda_still, flow=lambda_flow),
            num_points=self.num_points,
            densify_occ_percent=densify_occ_percent,
            densify_err_thre=densify_err_thre,
            densify_err_percent=densify_err_percent,
        )
        targets = self._targets(move_mask=move_mask, occ_mask=mask)
        phase = tel.phase if tel is not None else (lambda name: contextlib.nullcontext())

        with phase("device/stage"):
            self.params, self.state, info = train_stage(
                self.params, self.state, targets, self.intr, self.gen, cfg, dyn,
                device=self.device, graphs=self.graphs)
            # one batched pull of everything the host needs from this stage;
            # it also waits for the stage, attributing device time here
            pull = {"tile_overflow": info["tile_overflow"], "metrics": info["metrics"],
                    "last_num": self.state.last_num}
            if "t_final_overflow_mean" in info:
                pull["t_final_mean"] = info["t_final_overflow_mean"]
                pull["t_final_max"] = info["t_final_overflow_max"]
            if not camera_only:
                pull.update(uv=info["uv"], n_alive=info["n_alive"],
                            still_mask=self.state.still_mask)
            if "snapshots" in info:
                pull["snapshots"] = info["snapshots"]
            if "stamps" in info:
                pull["stamps"] = info["stamps"]
            pulled = _host(pull)
        if "stamps" in pulled:
            # each piece's device seconds over the stage, in iterations
            for piece, sec in stamp_pieces(pulled["stamps"]).items():
                calls = cfg.iterations - 1 if piece == "between" else cfg.iterations
                tel.add("iter/" + piece, sec, calls)
        self._last_info = info
        self.last_tile_overflow = float(pulled["tile_overflow"])
        if "t_final_mean" in pulled:
            self.last_t_final = {"mean": float(pulled["t_final_mean"]),
                                 "max": float(pulled["t_final_max"])}
            self._k_escalation_check(ckpt_name)

        out = {
            "frames": [], "frames_center": [], "frames_depth": [],
            "still_rgb": None, "still_center": None, "move_rgb": None, "move_center": None,
            "metrics": {k: float(v) for k, v in pulled["metrics"].items()},
        }
        if "snapshots" in pulled:
            snaps = pulled["snapshots"]
            out["frames"] = list(snaps["rgb"])
            out["frames_center"] = list(snaps["center"])
            out["frames_depth"] = list(snaps["depth_map"])

        # ---- move segmentation via concave hull (trainer.py:604-609) ----
        # (its pieces are named outside host/: fit.host_s_per_frame sums
        # the host/* phases, and a nested one would count twice)
        if not camera_only:
            with phase("host/hull_seg"):
                busy0 = writer_busy_s()
                with phase("hull/select"):
                    uv, n, still = pulled["uv"], int(pulled["n_alive"]), pulled["still_mask"]
                    within = ((uv[:, 0] > 0) & (uv[:, 0] < self.W - 1)
                              & (uv[:, 1] > 0) & (uv[:, 1] < self.H - 1))
                    within[n:] = False
                    moving = within & ~still
                    ratio = still[:n].sum() / max(n, 1)
                    print_color(f"\t[still] mask ratio is {ratio:.4f}")
                    sel = np.zeros(len(uv), bool)
                    if self.mask_prompt_pts is not None:
                        m = self.mask_prompt_pts
                        sel[: len(m)] = m
                        sel &= within
                    hull_moving, hull_prompt = moving.sum() > 5, sel.sum() > 4
                if hull_moving or hull_prompt:
                    with phase("hull/concave"):
                        if hull_moving:
                            hull = FastConcaveHull2D(uv[moving])
                            self.move_seg = (hull.mask(self.W, self.H) * 255).astype(np.uint8)
                        if hull_prompt:
                            hull = FastConcaveHull2D(uv[sel])
                            self.propagate_seg = (hull.mask(self.W, self.H) * 255).astype(
                                np.uint8)
                if hull_moving:
                    with phase("hull/erode"):
                        self.move_seg_erode = _erode(self.move_seg, 20)
                if tel is not None:  # the writer thread's seconds beside the hull
                    tel.add("writer/busy_in_hull", writer_busy_s() - busy0)

        # ---- diagnostic renders + still/move decomposition (trainer.py:627-697)
        out["last_rgb"] = _host((info["rgb"].clamp(0.0, 1.0) * 255).to(torch.uint8))
        subsets, views = None, None
        last_num = self._last_num_host = int(pulled["last_num"])
        if (save_imgs and self.dir) or last_num > 0:
            with phase("host/diag_renders"):
                views = self._last_views = self._diag_views()
            if last_num > 0:
                subsets = ((views["still_rgb"], views["still_center"]),
                           (views["move_rgb"], views["move_center"]))
        if save_imgs and self.dir:
            with phase("host/save_images"):
                self._save_stage_images(views, ckpt_name, subsets=subsets)
        if save_videos and self.dir and out["frames"]:
            from ..viz.video import save_video

            with phase("host/video_mux"):
                w = get_writer()
                for nm, fr in [("training_rgb", out["frames"]),
                               ("training_center", out["frames_center"]),
                               ("training_depth", out["frames_depth"])]:
                    w.submit(save_video, os.path.join(self.dir, f"{nm}.mp4"), fr, 30)
        if save_ckpt:
            with phase("host/checkpoint"):
                self.save_checkpoint(ckpt_name=ckpt_name)
        if tel is not None and save_imgs and self.dir:
            # the writer's seconds since the last record (summed over its
            # lanes), and the jobs it has not finished
            busy = writer_busy_s()
            tel.add("writer/busy", busy - self._writer_mark[1])
            tel.count("writer/backlog", writer_backlog())
            self._writer_mark = (tel, busy)

        out["move_seg"] = self.move_seg
        if subsets is not None:
            (out["still_rgb"], out["still_center"]) = subsets[0]
            (out["move_rgb"], out["move_center"]) = subsets[1]
        return out

    def _k_escalation_check(self, ckpt_name):
        """The K-escalation guardrail: the depth-sorted nearest-K truncation
        is safe only while the residual transmittance on overflowing tiles
        stays small. When the end-of-stage mean exceeds the threshold
        (halved on the first measured stage, the pre-seed), later stages
        jump straight to k_escalate_max."""
        thr = self.k_escalate_threshold
        preseed = thr is not None and not self._k_seen_first_stage
        self._k_seen_first_stage = True
        if preseed:
            thr = thr * self.k_preseed_fraction
        if (thr is not None and self.last_t_final["mean"] > thr
                and self.render_config.max_per_tile < self.k_escalate_max):
            new_k = self.k_escalate_max
            print_color(
                f"\t[render] t_final on overflow tiles {self.last_t_final['mean']:.4f} > "
                f"{thr}{' (frame-0 pre-seed)' if preseed else ''} — escalating "
                f"max_per_tile {self.render_config.max_per_tile} -> {new_k}",
                color="yellow")
            self.render_config = dataclasses.replace(self.render_config,
                                                     max_per_tile=new_k)
            self.k_escalations.append({"ckpt": ckpt_name, "to_k": new_k,
                                       "preseed": preseed,
                                       "t_final_mean": self.last_t_final["mean"]})

    # ------------------------------------------------------------------
    # rendering helpers
    # ------------------------------------------------------------------

    def _activated(self):
        alive = (torch.arange(self.capacity, device=self.device) < self.state.n_alive)[:, None]
        return (self.params.xyz, torch.abs(self.params.scale),
                activate("rotate", self.params.rotate),
                activate("opacity", self.params.opacity) * alive,
                activate("rgb", self.params.rgb))

    @torch.no_grad()
    def _diag_views(self) -> dict:
        """The post-stage diagnostic renders (``_diag``) as uint8 host
        images, one CUDA graph per (bg, W, H, render config, capacity)."""
        inputs = dict(params=self.params, n_alive=self.state.n_alive,
                      last_num=self.state.last_num, still_mask=self.state.still_mask,
                      intr=self.intr)
        static = dict(bg=self.bg, W=self.W, H=self.H, config=self.render_config)
        return _host(self.forward_graphs["diag"](
            tuple(static.values()), functools.partial(_diag, **static), inputs, self.device,
            self.render_config.band_devices))

    @torch.no_grad()
    def render_views(self, outputs=("rgb", "center", "depth_map_color"), as_uint8=False):
        """Render the current scene from the current camera: a dict of
        tensors on the trainer's device (see ops.render.render_jit)."""
        xyz, scale, rotate, opacity, rgb = self._activated()
        return render_jit(xyz, scale, rotate, opacity, rgb, self.intr, self.get_extr(),
                          self.bg, self.W, self.H, outputs, self.render_config,
                          as_uint8=as_uint8, device=self.device)

    def _save_stage_images(self, views, ckpt_name, subsets=None):
        """Queue the stage's diagnostic PNGs on the background writer, each
        keyed by its path (the lanes encode them in parallel)."""
        w = get_writer()
        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        for nm, key in (("img", "rgb"), ("img_center", "center"),
                        ("img_depth", "depth_map_color")):
            path = os.path.join(img_dir, f"{nm}_{ckpt_name}.png")
            w.submit_keyed(path, imwrite, path, views[key])
        if subsets is not None:
            (srgb, scen), (mrgb, mcen) = subsets
            for nm, arr in (("still", srgb), ("still_center", scen),
                            ("move", mrgb), ("move_center", mcen)):
                path = os.path.join(img_dir, f"img_{nm}_{ckpt_name}.png")
                w.submit_keyed(path, imwrite, path, arr)
        seg_dir = os.path.join(self.dir, "images_seg")
        for nm, arr in (("move_mask", self.move_seg),
                        ("move_mask_erode", self.move_seg_erode),
                        ("propagate_mask", self.propagate_seg)):
            if arr is not None:
                os.makedirs(seg_dir, exist_ok=True)
                path = os.path.join(seg_dir, f"{nm}_{ckpt_name}.png")
                w.submit_keyed(path, imwrite, path, arr.copy())

    def flush_io(self):
        """Drain the background writer (fit_video does so at the end of its
        run; an atexit hook also drains at interpreter exit)."""
        flush_writes()

    @torch.no_grad()
    def project_points(self, points):
        """World points -> (uv (N, 2), depth (N, 1)) NumPy arrays through the
        current camera (the counterpart of ``_compiled_world2pix``)."""
        inputs = dict(points=torch.from_numpy(np.array(points, np.float32)), intr=self.intr,
                      pose=self.params.pose)
        uv, depth = self.forward_graphs["world2pix"]((), _world2pix, inputs, self.device)
        return uv.cpu().numpy(), depth.cpu().numpy()

    @torch.no_grad()
    def gather_project(self, index):
        """(xyz, uv) NumPy arrays of a fixed query subset; only the selected
        rows leave the device (the counterpart of ``_compiled_gather_project``;
        the index set is uploaded once per set, as the JAX trainer caches its
        upload)."""
        index = np.asarray(index, np.int64)
        if self._gather_key != index.tobytes():
            self._gather_key = index.tobytes()
            self._gather_index = torch.from_numpy(index).to(self.device)
        inputs = dict(xyz=self.params.xyz, index=self._gather_index, intr=self.intr,
                      pose=self.params.pose)
        sel, uv = self.forward_graphs["gather_project"]((), _gather_project, inputs, self.device)
        return sel.cpu().numpy(), uv.cpu().numpy()

    # ------------------------------------------------------------------
    # mask-prompt propagation (trainer.py:290-330)
    # ------------------------------------------------------------------

    def init_mask_prompt_pts(self, mask_prompt: np.ndarray, ckpt_name: str):
        uv, _ = self.project_points(self.params.xyz.cpu().numpy())
        n = int(self.state.n_alive)
        within = ((uv[:, 0] > 0) & (uv[:, 0] < self.W - 1)
                  & (uv[:, 1] > 0) & (uv[:, 1] < self.H - 1))
        within[n:] = False
        sel = np.zeros(len(uv), bool)
        xi = np.clip(uv[:, 0].astype(int), 0, self.W - 1)
        yi = np.clip(uv[:, 1].astype(int), 0, self.H - 1)
        sel[within] = np.asarray(mask_prompt)[yi[within], xi[within]] > 0
        self.mask_prompt_pts = sel
        if self.dir:
            seg_dir = os.path.join(self.dir, "images_seg")
            os.makedirs(seg_dir, exist_ok=True)
            imwrite(os.path.join(seg_dir, f"propagate_mask_{ckpt_name}.png"),
                    (np.asarray(mask_prompt) > 0).astype(np.uint8) * 255)

    # ------------------------------------------------------------------
    # checkpoints (trainer.py:252-288; npz instead of torch .tar)
    # ------------------------------------------------------------------

    def _grow_capacity(self, new_capacity: int):
        """Re-pad every capacity-shaped array (params and frame state) to a
        larger capacity."""
        if new_capacity <= self.capacity:
            return
        old = self.capacity

        def pad_arr(x, fill):
            x = x.cpu().numpy()
            out = np.full((new_capacity,) + x.shape[1:], fill, x.dtype)
            out[:old] = x
            return torch.from_numpy(out).to(self.device)

        self.params = self.params._replace(
            xyz=pad_arr(self.params.xyz, 0.0),
            scale=pad_arr(self.params.scale, 1e-8),
            rotate=pad_arr(self.params.rotate, 0.5),
            opacity=pad_arr(self.params.opacity, -10.0),
            rgb=pad_arr(self.params.rgb, 0.0),
        )
        self.state = self.state._replace(
            still_mask=pad_arr(self.state.still_mask, True),
            still_mask_tentative=pad_arr(self.state.still_mask_tentative, True),
            last_uv=pad_arr(self.state.last_uv, 0.0),
            last_depth=pad_arr(self.state.last_depth, 0.0),
            last_xyz=pad_arr(self.state.last_xyz, 0.0),
        )
        if self.mask_prompt_pts is not None:
            self.mask_prompt_pts = np.concatenate(
                [self.mask_prompt_pts, np.zeros(new_capacity - old, bool)])
        self.capacity = new_capacity

    def save_checkpoint(self, ckpt_name="ckpt"):
        """ckpt/<ckpt_name>.npz with the JAX package's keys and dtypes:
        the live rows of xyz/scale/rotate/opacity/rgb (raw, float32),
        still_mask (bool) and last_uv, intr, extr (3, 4), move_seg (uint8,
        or an empty float64 array when unset), width, height and, when
        set, pose_list."""
        os.makedirs(os.path.join(self.dir, "ckpt"), exist_ok=True)
        path = os.path.join(self.dir, "ckpt", f"{ckpt_name}.npz")
        pulled = _host({
            "n_alive": self.state.n_alive,
            "xyz": self.params.xyz,
            "scale": self.params.scale,
            "rotate": self.params.rotate,
            "opacity": self.params.opacity,
            "rgb": self.params.rgb,
            "intr": self.intr,
            "extr": self.get_extr(),
            "still_mask": self.state.still_mask,
            "last_uv": self.state.last_uv,
        })
        n = int(pulled.pop("n_alive"))
        for k in ("xyz", "scale", "rotate", "opacity", "rgb", "still_mask", "last_uv"):
            pulled[k] = pulled[k][:n]
        extras = {}
        if self.pose_list is not None:
            extras["pose_list"] = np.asarray(self.pose_list, np.float32)
        np.savez(path, move_seg=self.move_seg if self.move_seg is not None else np.zeros(0),
                 width=self.W, height=self.H, **extras, **pulled)
        self.checkpoint_path = path

    def load_checkpoint(self, path, show=False):
        """Load an npz of either package; a checkpoint with more points than
        the capacity grows it to the next power of two first."""
        d = np.load(path, allow_pickle=False)
        n = d["xyz"].shape[0]
        if n > self.capacity:
            self._grow_capacity(1 << int(np.ceil(np.log2(n))))

        def pad(x, fill=0.0):
            out = np.full((self.capacity,) + x.shape[1:], fill, np.float32)
            out[:n] = x
            return torch.from_numpy(out).to(self.device)

        self.params = self.params._replace(
            xyz=pad(d["xyz"]),
            scale=pad(d["scale"], 1e-8),
            rotate=pad(d["rotate"], 0.5),
            opacity=pad(d["opacity"], -10.0),
            rgb=pad(d["rgb"]),
        )
        self.intr = torch.from_numpy(np.asarray(d["intr"], np.float32)).to(self.device)
        self.load_camera(extr=d["extr"], show=show)
        still = np.ones(self.capacity, bool)
        still[:n] = d["still_mask"]
        lu = np.zeros((self.capacity, 2), np.float32)
        lu[:n] = d["last_uv"]
        self.state = self.state._replace(
            n_alive=torch.tensor(n, dtype=torch.int32, device=self.device),
            last_num=torch.tensor(n, dtype=torch.int32, device=self.device),
            still_mask=torch.from_numpy(still).to(self.device),
            last_uv=torch.from_numpy(lu).to(self.device),
        )
        self._last_num_host = n
        if d["move_seg"].size:
            self.move_seg = d["move_seg"]
        if "pose_list" in d:
            self.pose_list = list(d["pose_list"])
        self._last_views = None

    # ------------------------------------------------------------------
    # trajectory eval (trainer.py:713-811)
    # ------------------------------------------------------------------

    def eval(self, traj_index, line_scale=0.1, point_scale=0.3, alpha=0.5,
             split_interval=None, need_center_depth=True, return_query_uv=False):
        traj_index = np.asarray(traj_index, int)
        num_traj = len(traj_index)
        xyz_now, uv_now = self.gather_project(traj_index)

        if self._traj is None:
            # exact-count ramps (np.arange(0, 1, 1/n) can emit n + 1)
            if split_interval is None or num_traj == split_interval:
                ramp = (np.arange(num_traj, dtype=np.float32) / num_traj)[:, None]
            else:
                n2 = num_traj - split_interval
                r1 = np.arange(split_interval, dtype=np.float32) / split_interval
                r2 = np.arange(n2, dtype=np.float32) / n2
                ramp = np.concatenate([r1, r2])[:, None]
            rgb = apply_float_colormap(torch.from_numpy(ramp), colormap="gist_rainbow").numpy()
            self._traj = {"xyz": xyz_now.copy(),
                          "opacity": np.full((num_traj, 1), 0.99, np.float32),
                          "rgb": rgb, "last_xyz": xyz_now.copy(), "last_rgb": rgb.copy()}
            # a fixed line-set capacity, set at the first append from the
            # measured per-frame growth, and a lean fixed render config
            # (trajectory splats are points and thin lines: M=8 covers them)
            self._traj_cap = max(4096, _pow2ceil(num_traj))
            self._traj_cap_fixed = False
            self._traj_cfg = dataclasses.replace(self.render_config,
                                                 max_tiles_per_gaussian=8, max_per_tile=128)
        else:
            t = self._traj
            line_xyz, line_rgb = _gen_line_set(t["last_xyz"], xyz_now, t["last_rgb"])
            t["xyz"] = np.concatenate([t["xyz"], line_xyz])
            t["opacity"] = np.concatenate(
                [t["opacity"] * alpha, np.full((len(line_xyz), 1), 0.99, np.float32)])
            t["rgb"] = np.concatenate([t["rgb"], line_rgb])
            t["last_xyz"] = xyz_now.copy()
            if not self._traj_cap_fixed:
                # room for >= 3 more frames of the first append's growth
                self._traj_cap = max(self._traj_cap, _pow2ceil(
                    len(t["xyz"]) + 3 * (len(line_xyz) + num_traj)))
                self._traj_cap_fixed = True
            if len(t["xyz"]) > self._traj_cap:
                # drop the oldest (most faded: opacity decays by alpha per
                # frame) prefix
                drop = len(t["xyz"]) - self._traj_cap
                for k in ("xyz", "opacity", "rgb"):
                    t[k] = t[k][drop:]

        # reuse the stage's own diagnostic render, once
        views, self._last_views = self._last_views, None
        if views is None or (need_center_depth and "center" not in views):
            outs = ("rgb", "center", "depth_map_color") if need_center_depth else ("rgb",)
            views = _host(self.render_views(outs, as_uint8=True))
        out_img = views["rgb"]
        out_center = views["center"] if need_center_depth else None
        out_depth = views["depth_map_color"] if need_center_depth else None

        out_traj = _host(self.traj_image(num_traj, line_scale, point_scale, as_uint8=True))
        # screen blending (trainer.py:798-806)
        a1 = out_img.astype(np.float32) / 255
        a2 = out_traj.astype(np.float32) / 255
        upon = ((1 - (1 - a1) * (1 - a2)) * 255).astype(np.uint8)
        if return_query_uv:
            return out_img, out_center, out_depth, out_traj, upon, uv_now
        return out_img, out_center, out_depth, out_traj, upon

    @torch.no_grad()
    def traj_image(self, point_num: int, line_scale: float, point_scale: float,
                   as_uint8: bool = False):
        """The trajectory line set rendered from the current camera, (H, W,
        3) on the trainer's device, float or, with as_uint8, quantized:
        padded to its fixed capacity (padding behind the camera at opacity
        0), the last point_num entries drawn as points. One CUDA graph per
        static call shape and capacity (``_traj_render``); the line set and
        its count are data."""
        t, cap = self._traj, self._traj_cap
        nt = len(t["xyz"])
        xyz_p = np.zeros((cap, 3), np.float32)
        xyz_p[:nt] = t["xyz"]
        xyz_p[nt:, 2] = -1.0
        op_p = np.zeros((cap, 1), np.float32)
        op_p[:nt] = t["opacity"]
        rgb_p = np.zeros((cap, 3), np.float32)
        rgb_p[:nt] = t["rgb"]
        inputs = dict(xyz=torch.from_numpy(xyz_p), opacity=torch.from_numpy(op_p),
                      rgb=torch.from_numpy(rgb_p), intr=self.intr, pose=self.params.pose,
                      n_actual=torch.tensor(nt, dtype=torch.int32))
        static = dict(bg=float(self.bg), W=self.W, H=self.H, point_num=int(point_num),
                      line_scale=float(line_scale), point_scale=float(point_scale),
                      config=self._traj_cfg, as_uint8=bool(as_uint8))
        return self.forward_graphs["traj"](
            tuple(static.values()), functools.partial(_traj_render, **static), inputs,
            self.device, self._traj_cfg.band_devices)
