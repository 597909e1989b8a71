"""Multi-GPU training: the tile-band fitting mode's dry run, and a batched
B-frame harness.

Counterpart of ``gflow_tpu/parallel/multichip.py``.

THE PRODUCT MODE is the tile-band single-sequence fit (``dryrun_stage``
here, ``fit_video(shard_devices=N)`` end to end): the unmodified
``opt.train.train_stage`` runs under ``use_mesh(mesh)``, and its
RenderConfig composites the tile rows in one band per device of the mesh
(``ops/cuda_raster.composite_tiles_kernel_sharded``). Projection, binning,
losses, densify and Adam run on the stage's own device; the backward's
per-Gaussian sum over bands is the packed gather's transpose
(``index_add_``) there.

ALSO HERE, a batched B-frame harness (``composite_tiles_batched``,
``batched_forward``, ``sharded_train_step``, ``dryrun_step``): B
independent frame fits, frame b composited on the data row b * D // B of
a ("data", "tile") mesh, in bands over that row's tile devices, through
the same band compositor. It is evidence machinery (the equality of a
step on 8 devices and on 1), not a user mode: a sequence's frames are fit
one after another, and the product's batch axis is scenes
(``parallel/scene_sweep.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.camera import pose_to_extr
from ..ops import cuda_raster
from ..ops.binning import tile_grid
from ..ops.projection import project_gaussians, supported_max_radius
from ..ops.render import RenderConfig, bin_with
from ..opt.losses import LossWeights, compute_losses
from ..opt.state import FrameState, Params, Targets, adam_update, init_frame_state, init_opt_state
from ..opt.train import StageConfig, StageDynamics, _activate, _gate_grads, train_stage
from .mesh import Mesh, ambient_tile_devices, make_mesh, use_mesh


def composite_tiles_batched(tile_lists, uv, conic, opacity, features, bg, W: int, H: int,
                            n_tx: int, n_ty: int, mesh: Mesh, tile_counts=None):
    """Batched tile compositing: tile_lists (B, T, K), point arrays
    (B, N, .), tile_counts (B, T) or None. Returns (B, H, W, F) on uv's
    device. Frame b goes to data row b * D // B of the ("data", "tile")
    `mesh` and composites in bands over that row's devices."""
    B, rows = tile_lists.shape[0], mesh.devices
    return torch.stack([cuda_raster.composite_tiles_kernel_sharded(
        tile_lists[b], uv[b], conic[b], opacity[b], features[b], bg, W, H, n_tx, n_ty,
        rows[b * len(rows) // B], tile_counts=None if tile_counts is None else tile_counts[b])
        for b in range(B)])


def _frame(tree, b):
    return type(tree)(*(x[b] for x in tree))


def batched_forward(bparams: Params, bstate: FrameState, btargets: Targets, intr,
                    cfg: StageConfig, weights: LossWeights, mesh: Mesh):
    """One batched render + loss over the B frames of the batched trees
    (leading axis B), composited over the ("data", "tile") `mesh`.
    Returns (mean loss, aux)."""
    B = bparams.xyz.shape[0]
    n_tx, n_ty = tile_grid(cfg.W, cfg.H)
    mr = supported_max_radius(cfg.render.max_tiles_per_gaussian)
    per = []
    for b in range(B):
        p = _frame(bparams, b)
        scale, rotate, opacity, rgb = _activate(p, bstate.n_alive[b])
        proj = project_gaussians(p.xyz, scale, rotate, intr, pose_to_extr(p.pose), cfg.W,
                                 cfg.H, max_radius=mr)
        bins = bin_with(cfg.render, proj["uv"], proj["depth"], proj["radius"], cfg.W, cfg.H)
        per.append((proj, bins, scale, opacity, torch.cat([rgb, proj["depth"]], dim=1)))
    stack = lambda f: torch.stack([f(x) for x in per])
    img = composite_tiles_batched(
        stack(lambda x: x[1].tile_lists), stack(lambda x: x[0]["uv"]),
        stack(lambda x: x[0]["conic"]), stack(lambda x: x[3]), stack(lambda x: x[4]), cfg.bg,
        cfg.W, cfg.H, n_tx, n_ty, mesh=mesh, tile_counts=stack(lambda x: x[1].tile_counts))
    totals, metrics = [], []
    for b, (proj, _, scale, _, _) in enumerate(per):
        total, m, _ = compute_losses(
            img[b, ..., :3], img[b, ..., 3:4], proj["uv"], proj["depth"], scale,
            bparams.xyz[b], bparams.depth_ab[b], _frame(btargets, b), _frame(bstate, b),
            weights, cfg.camera_only, cfg.W, cfg.H)
        totals.append(total)
        metrics.append(m)
    metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    return torch.stack(totals).mean(), {"metrics": metrics, "rgb": img[..., :3]}


def sharded_train_step(mesh: Mesh, cfg: StageConfig, dyn: StageDynamics):
    """(step, data_shard): step(bparams, bopt, bstate, btargets, intr) runs
    one batched forward over `mesh`, the gated gradients per frame and
    Adam, and returns (bparams, bopt, loss, rgb); data_shard moves a
    batched tree to the mesh's first device, where the batch lives."""
    home = mesh.flat[0]

    def data_shard(tree):
        return type(tree)(*(x.to(home) for x in tree))

    def step(bparams, bopt, bstate, btargets, intr):
        leaves = [x.detach().requires_grad_() for x in bparams]
        loss, aux = batched_forward(Params(*leaves), bstate, btargets, intr, cfg, dyn.weights,
                                    mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = Params(*(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)))
        gated = [_gate_grads(_frame(grads, b), _frame(bstate, b), bstate.n_alive[b],
                             cfg.camera_only) for b in range(len(bstate.n_alive))]
        grads = Params(*(torch.stack(g) for g in zip(*gated)))
        bparams2, bopt2 = adam_update(Params(*(x.detach() for x in leaves)), grads, bopt,
                                      dyn.lr, dyn.lr_camera, dyn.lr)
        return bparams2, bopt2, loss.detach(), aux["rgb"].detach()

    return step, data_shard


def _stage_inputs(rng, capacity: int, W: int, H: int):
    """Random Gaussians in front of an identity camera (numpy, in the JAX
    dry runs' draw order: xyz, scale, rgb)."""
    return dict(
        xyz=np.c_[rng.uniform(-1, 1, (capacity, 2)),
                  rng.uniform(1.5, 4.0, (capacity, 1))].astype(np.float32),
        scale=rng.uniform(0.01, 0.05, (capacity, 3)).astype(np.float32),
        rotate=np.tile(np.asarray([1, 0, 0, 0], np.float32), (capacity, 1)),
        opacity=np.full((capacity, 1), 0.3, np.float32),
        rgb=rng.normal(0, 1, (capacity, 3)).astype(np.float32),
        pose=np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32),
        depth_ab=np.asarray([1, 0], np.float32),
    )


def _tensors(cls, d, device):
    return cls(*(torch.as_tensor(d[k]).to(device) for k in cls._fields))


def dryrun_stage(mesh: Mesh, iterations: int = 12, W: int = 64, H: int = 48,
                 capacity: int = 512, seed: int = 0):
    """The PRODUCT mode, dry-run sized: the full single-frame
    ``opt.train.train_stage`` (iterations, an occluded-region densify at 0
    and an error densify halfway, finalize) under ``use_mesh(mesh)``, its
    tile rows in bands over every device of the mesh. Returns (final total
    loss, n_alive)."""
    dev = mesh.flat[0]
    rng = np.random.default_rng(seed)
    params = _tensors(Params, _stage_inputs(rng, capacity, W, H), dev)
    state = init_frame_state(capacity, dev)._replace(
        n_alive=torch.tensor(capacity - 64, dtype=torch.int32, device=dev))
    targets = _tensors(Targets, dict(
        image=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        depth=np.full((H, W, 1), 2.0, np.float32), flow=np.zeros((H, W, 2), np.float32),
        move_mask=np.zeros((H, W), bool), occ_mask=rng.random((H, W)) < 0.1), dev)
    dyn = StageDynamics(lr=1e-2, lr_camera=1e-3, weights=LossWeights(rgb=1.0, depth=0.1),
                        num_points=capacity // 2, densify_occ_percent=0.5)
    with use_mesh(mesh):
        bands = ambient_tile_devices()
        assert bands, "the mesh must have a 'tile' axis"
        cfg = StageConfig(W=W, H=H, iterations=iterations, densify_occ=True,
                          densify_interval=max(2, iterations // 2), densify_times=1,
                          max_densify=64, render=RenderConfig(max_per_tile=64,
                                                              band_devices=bands))
        gen = torch.Generator(device=dev).manual_seed(0)
        _, s2, info = train_stage(params, state, targets, [60.0, 60.0, W / 2, H / 2], gen,
                                  cfg, dyn, device=dev)
    total = float(info["metrics"]["total"])
    if not math.isfinite(total):
        raise RuntimeError("the banded stage produced a non-finite loss")
    n_alive = int(s2.n_alive)
    if n_alive <= capacity - 64:
        raise RuntimeError("densify did not run in the banded stage")
    return total, n_alive


def dryrun_step(mesh: Mesh, B: int | None = None, W: int = 64, H: int = 48,
                capacity: int = 512, seed: int = 0, max_per_tile: int = 64,
                max_tiles_per_gaussian: int = 16):
    """Build batched inputs (the JAX dryrun_step's draws from `seed`), run
    ONE batched step over the mesh and check its outputs. Returns the
    mean loss before the update."""
    if B is None:
        B = mesh.shape.get("data", 1)
    dev = mesh.flat[0]
    rng = np.random.default_rng(seed)
    frames = [_stage_inputs(rng, capacity, W, H) for _ in range(B)]
    bparams = Params(*(torch.from_numpy(np.stack([f[k] for f in frames]))
                       for k in Params._fields))
    st = init_frame_state(capacity, "cpu")._replace(
        n_alive=torch.tensor(capacity, dtype=torch.int32))
    bstate = FrameState(*(torch.stack([x] * B) for x in st))
    tgt = dict(image=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
               depth=np.full((H, W, 1), 2.0, np.float32), flow=np.zeros((H, W, 2), np.float32),
               move_mask=np.zeros((H, W), bool), occ_mask=np.zeros((H, W), bool))
    btargets = Targets(*(torch.from_numpy(np.stack([tgt[k]] * B)) for k in Targets._fields))
    cfg = StageConfig(W=W, H=H, iterations=1,
                      render=RenderConfig(max_per_tile=max_per_tile,
                                          max_tiles_per_gaussian=max_tiles_per_gaussian))
    dyn = StageDynamics(lr=1e-2, lr_camera=1e-3, weights=LossWeights(rgb=1.0, depth=0.1))
    step, data_shard = sharded_train_step(mesh, cfg, dyn)
    bparams, bstate, btargets = data_shard(bparams), data_shard(bstate), data_shard(btargets)
    bopt = init_opt_state(bparams)
    intr = torch.tensor([60.0, 60.0, W / 2, H / 2], device=dev)
    bparams2, _, loss, _ = step(bparams, bopt, bstate, btargets, intr)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("the batched step produced a non-finite loss")
    if not float((bparams2.xyz - bparams.xyz).abs().max()) > 0:
        raise RuntimeError("the batched step did not update the parameters")
    return float(loss)


def dryrun_multigpu(n_devices: int | None = None, device=None) -> dict:
    """Counterpart of ``__graft_entry__.dryrun_multichip``: one batched
    step over a ("data", "tile") mesh of n devices (make_mesh: cards, or n
    bands on the CPU with device "cpu"), then the 12-iteration banded
    stage with densify over the same mesh."""
    mesh = make_mesh(n_devices, device=device)
    loss = dryrun_step(mesh)
    print(f"dryrun_multigpu({len(mesh.flat)}): mesh {mesh.shape} ok, one batched step, "
          f"loss={loss:.4f}")
    total, n_alive = dryrun_stage(mesh, iterations=12)
    print(f"dryrun_multigpu({len(mesh.flat)}): 12-iteration banded stage with densify ok, "
          f"loss={total:.4f}, n_alive={n_alive}")
    return {"step_loss": loss, "stage_loss": total, "n_alive": n_alive}
