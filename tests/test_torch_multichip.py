"""The port's tile-band fitting mode and B-frame harness
(gflow_tpu_torch.parallel.multichip) on the CPU, against the JAX
package's tile-sharded stage and dryrun_step on the virtual CPU devices.

- The banded train_stage (4 CPU bands; a 6-iteration full stage with an
  occluded-region densify at 0, and a 6-iteration camera-only stage) on
  tests/test_multichip.py's _tiny_stage_inputs(seed=7), against JAX's
  train_stage under jax.set_mesh(fitting_mesh(4)) with the tile axis
  sharded (backend "xla": GSPMD partitions the XLA compositor; its
  compile is the faster of the two on the CPU) and against the port's
  unbanded stage. The port's densify draws JAX's uniforms (the stage's
  first key split), so both packages densify the same pixels. Every
  parameter leaf within atol 2e-4 and the final losses within rtol 1e-4,
  against JAX and against the unbanded port, as tests/test_multichip.py
  holds JAX's sharded stage against its unsharded one (on the CPU the
  banded port equals the unbanded one and lies at most 6e-5 from JAX, on
  rotate).
- dryrun_step: 8 devices (2 x 4 mesh) against 1, rtol 1e-5
  (test_sharded_step_matches_unsharded), and against JAX's dryrun_step
  on its 8-device mesh at the same seed, rtol 1e-4 (two compositor
  formulations; the loss is a mean over 2 x 3,072 pixels).
- dryrun_multigpu(4, "cpu") runs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.opt import StageConfig as JStageConfig, StageDynamics as JDyn
from gflow_tpu.opt import train_stage as j_train_stage
from gflow_tpu.opt.losses import LossWeights as JWeights
from gflow_tpu.ops.render import RenderConfig as JConfig
from gflow_tpu.parallel import make_mesh as j_make_mesh
from gflow_tpu.parallel.mesh import fitting_mesh as j_fitting_mesh
from gflow_tpu.parallel.multichip import dryrun_step as j_dryrun_step
from gflow_tpu_torch import convert
from gflow_tpu_torch.ops.render import RenderConfig
from gflow_tpu_torch.opt.losses import LossWeights
from gflow_tpu_torch.opt.train import StageConfig, StageDynamics, train_stage
from gflow_tpu_torch.parallel.mesh import ambient_tile_devices, fitting_mesh, make_mesh, use_mesh
from gflow_tpu_torch.parallel.multichip import dryrun_multigpu, dryrun_step
from tests.test_multichip import _tiny_stage_inputs

W, H, ITERS, MAX_DENSIFY = 64, 48, 6, 64
DYN = dict(lr=1e-2, lr_camera=1e-3, num_points=256, densify_occ_percent=0.5)


def stage_cfg(camera_only, **render):
    return dict(W=W, H=H, iterations=ITERS, camera_only=camera_only,
                densify_occ=not camera_only, max_densify=MAX_DENSIFY), render


@pytest.fixture(scope="module")
def inputs():
    params, state, targets = _tiny_stage_inputs(seed=7, W=W, H=H)
    state = state._replace(last_num=state.n_alive)  # movers for the camera-only stage
    return params, state, targets


def jax_stage(inputs, camera_only):
    params, state, targets = inputs
    kw, _ = stage_cfg(camera_only)
    dyn = JDyn.make(weights=JWeights.make(rgb=1.0, depth=0.1), **DYN)
    with jax.set_mesh(j_fitting_mesh(4)):
        cfg = JStageConfig(render=JConfig(max_per_tile=64, tile_shard_axes=("tile",),
                                          backend="xla"), **kw)
        fn = jax.jit(functools.partial(j_train_stage, cfg=cfg, dyn=dyn))
        p, s, info = fn(params, state, targets, jnp.asarray([60.0, 60.0, W / 2, H / 2]),
                        jax.random.PRNGKey(0))
        return jax.tree.map(np.asarray, (p._asdict(), s._asdict(), info["metrics"]))


def port_stage(inputs, camera_only, band_devices, monkeypatch):
    params, state, targets = (jax.tree.map(np.asarray, x._asdict()) for x in inputs)
    kw, _ = stage_cfg(camera_only)
    # JAX's densify uniforms: the first split of the stage's key
    draws = [torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.split(jax.random.PRNGKey(0))[1], (MAX_DENSIFY,))))]
    rand = torch.rand

    def jax_draw(n, generator=None, device=None):
        assert n == MAX_DENSIFY
        return draws.pop(0).to(device)

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", jax_draw)
        p, s, info = train_stage(
            convert.params_from_numpy(params, "cpu"), convert.frame_state_from_numpy(state, "cpu"),
            convert.targets_from_numpy(targets, "cpu"), [60.0, 60.0, W / 2, H / 2],
            torch.Generator().manual_seed(0),
            StageConfig(render=RenderConfig(max_per_tile=64, band_devices=band_devices), **kw),
            StageDynamics(weights=LossWeights(rgb=1.0, depth=0.1), **DYN), device="cpu")
    assert torch.rand is rand and (camera_only or not draws)  # the densify drew JAX's draw
    return convert.params_to_numpy(p), convert.frame_state_to_numpy(s), {
        k: float(v) for k, v in info["metrics"].items()}


@pytest.mark.parametrize("camera_only", [False, True])
def test_banded_stage_matches_jax_and_unbanded(inputs, camera_only, monkeypatch):
    with use_mesh(fitting_mesh(4, "cpu")):
        bands = ambient_tile_devices()
    assert len(bands) == 4
    pb, sb, mb = port_stage(inputs, camera_only, bands, monkeypatch)
    pu, su, mu = port_stage(inputs, camera_only, None, monkeypatch)
    pj, sj, mj = jax_stage(inputs, camera_only)
    n0 = int(np.asarray(inputs[1].n_alive))
    assert int(sb["n_alive"]) == int(su["n_alive"]) == int(sj["n_alive"])
    assert (int(sb["n_alive"]) > n0) != camera_only  # the occ densify ran
    for k in pj:
        np.testing.assert_allclose(pb[k], pu[k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(pb[k], pj[k], atol=2e-4, err_msg=k)
    for k in ("rgb", "depth", "total"):
        np.testing.assert_allclose(mb[k], mu[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(mb[k], float(mj[k]), rtol=1e-4, err_msg=k)


def test_dryrun_step_matches_one_device_and_jax():
    l8 = dryrun_step(make_mesh(8, device="cpu"), B=2, seed=3)
    l1 = dryrun_step(make_mesh(1, device="cpu"), B=2, seed=3)
    np.testing.assert_allclose(l8, l1, rtol=1e-5)
    lj = j_dryrun_step(j_make_mesh(8, platform="cpu"), B=2, seed=3)
    np.testing.assert_allclose(l8, lj, rtol=1e-4)


def test_dryrun_multigpu_runs():
    out = dryrun_multigpu(4, "cpu")
    assert np.isfinite(out["step_loss"]) and np.isfinite(out["stage_loss"])
    assert out["n_alive"] > 512 - 64
