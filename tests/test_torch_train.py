"""Port parity: the train step and stage (gflow_tpu_torch.opt.train vs
gflow_tpu.opt.train), on the CPU, from identical parameters carried over
with gflow_tpu_torch.convert.

Tolerances and why:
- one forward: the total loss to 1e-5 relative; gradients normalized by
  each leaf's max |ref| to 1e-3 (sums over all pixels and Gaussians in
  another order, and two compositor formulations: the JAX package's XLA
  compositor on the CPU, the port's packed plain version);
- a stage: Adam divides by sqrt(v) + eps, so where |g| is ~0 a tiny
  gradient difference becomes a step of up to ~lr. Outliers are bounded:
  every parameter agrees within 3 * iterations * lr, and 99% of entries
  within 1e-4 (bulk) — the final losses to 1e-3 relative. The rebinning
  and snapshot paths are held the same way; the lists rebuilt after a
  densify are held against the port's own per-iteration binning, loss to
  1e-6 relative (the same lists: only float rounding differs);
- snapshots: uint8 stacks on >= 99% of pixels within 2 levels (the float
  images differ by ~1e-4, so a value on a quantization edge may land one
  level over, and the turbo depth colormap one bin over);
- densify counts: n_alive equal (an occ densify's count is deterministic,
  an error densify's saturates at max_densify), although the two packages
  draw different uniforms."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core.camera import default_intrinsics
from gflow_tpu.ops.render import RenderConfig as JConfig
from gflow_tpu.opt import losses as jlosses
from gflow_tpu.opt import state as jstate
from gflow_tpu.opt import train as jtrain
from gflow_tpu.opt.initialize import init_params_from_image as j_init
from gflow_tpu_torch import convert
from gflow_tpu_torch.ops.render import RenderConfig as TConfig
from gflow_tpu_torch.opt import losses as tlosses
from gflow_tpu_torch.opt import train as ttrain

W, H = 48, 32
C = 512
RC = dict(max_per_tile=64, max_tiles_per_gaussian=16)
WEIGHTS = dict(rgb=1.0, depth=0.1, var=50.0, scale=0.5, still=1.0, flow=0.01)


def frame(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 0.05, (H, W, 3))
    # inside (0, 1): the init's logit maps a saturated color to +-inf
    img = np.clip(img, 0.02, 0.98).astype(np.float32)
    depth = (1.5 + xx + 0.1 * yy).astype(np.float32)
    move = np.zeros((H, W), bool)
    move[8:20, 20:36] = True
    occ = np.zeros((H, W), bool)
    occ[4:20, 4:24] = True
    flow = rng.normal(0, 0.5, (H, W, 2)).astype(np.float32)
    return dict(image=img, depth=depth[..., None], flow=flow, move_mask=move, occ_mask=occ)


def start(seed=0, n=300, with_last=False):
    """Identical start for both packages: params from the JAX init, and
    optionally a fake previous frame so still/flow/coverage terms engage."""
    tg = frame(seed)
    intr = np.array(default_intrinsics(W, H))
    extr = np.c_[np.eye(3), np.zeros(3)].astype(np.float32)
    params, n = j_init(tg["image"], tg["depth"][..., 0], n, C, intr, extr,
                       rng=np.random.default_rng(seed))
    p = {k: np.array(v) for k, v in params._asdict().items()}
    p["pose"] = np.array([0.01, -0.02, 0.005, 1.0, 0.01, 0.0, 0.02], np.float32)
    # splats of 0.5-2.5 px sigma: the init's 1e-3 scales sit far below the
    # 0.3 px^2 dilation, where rotation gradients are f32 rounding noise
    p["scale"][:n] = np.random.default_rng(seed).uniform(0.03, 0.15, (n, 3))
    s = {k: np.array(v) for k, v in jstate.init_frame_state(C)._asdict().items()}
    s["n_alive"] = np.int32(n)
    if with_last:
        rng = np.random.default_rng(seed + 1)
        s["last_num"] = np.int32(n - 20)
        s["last_xyz"] = p["xyz"] + rng.normal(0, 0.01, p["xyz"].shape).astype(np.float32)
        s["last_uv"] = rng.uniform([0, 0], [W, H], (C, 2)).astype(np.float32)
        s["still_mask"] = rng.uniform(size=C) < 0.7
        s["still_mask_tentative"] = rng.uniform(size=C) < 0.7
    return p, s, tg, intr


def jax_side(p, s, tg):
    return (jstate.Params(**{k: jnp.asarray(v) for k, v in p.items()}),
            jstate.FrameState(**{k: jnp.asarray(v) for k, v in s.items()}),
            jstate.Targets(**{k: jnp.asarray(v) for k, v in tg.items()}))


def torch_side(p, s, tg):
    return (convert.params_from_numpy(p, "cpu"), convert.frame_state_from_numpy(s, "cpu"),
            convert.targets_from_numpy(tg, "cpu"))


def close_normalized(got, want, atol, what):
    ref = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got / ref, want / ref, atol=atol, err_msg=what)


@pytest.mark.parametrize("camera_only", [False, True])
def test_forward_and_grads_match_jax(camera_only):
    p, s, tg, intr = start(0, with_last=True)
    jp, js, jt = jax_side(p, s, tg)
    tp, ts, tt = torch_side(p, s, tg)
    jcfg = jtrain.StageConfig(W=W, H=H, iterations=1, camera_only=camera_only,
                              render=JConfig(**RC))
    tcfg = ttrain.StageConfig(W=W, H=H, iterations=1, camera_only=camera_only,
                              render=TConfig(**RC))

    def loss_j(params):
        return jtrain._forward(params, js.n_alive, js, jt, jnp.asarray(intr),
                               jlosses.LossWeights.make(**WEIGHTS), jcfg)

    (tot_j, aux_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jp)
    leaves = [x.clone().requires_grad_() for x in tp]
    tot_t, aux_t = ttrain._forward(type(tp)(*leaves), ts.n_alive, ts, tt,
                                   torch.from_numpy(intr), tlosses.LossWeights(**WEIGHTS), tcfg)
    g_t = torch.autograd.grad(tot_t, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tot_t.detach()), float(tot_j), rtol=1e-5)
    for k in ("rgb", "depth", "var", "scale", "still", "flow"):
        np.testing.assert_allclose(float(aux_t["metrics"][k]), float(aux_j["metrics"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(aux_t["rgb"].detach().numpy(), np.asarray(aux_j["rgb"]),
                               atol=1e-4)
    for name, gt, gj in zip(jp._fields, g_t, g_j):
        gj = np.asarray(gj)
        if gt is None:  # detached in the camera-only stage
            assert camera_only and name in ("opacity", "rgb"), name
            continue
        if camera_only and name in ("opacity", "rgb"):
            assert not np.abs(gj).any()
        close_normalized(gt.numpy(), gj, 1e-3, name)
    # the gated gradients (camera-only: attributes frozen) agree too
    gated_t = ttrain._gate_grads(type(tp)(*(torch.zeros_like(x) if g is None else g
                                            for g, x in zip(g_t, leaves))),
                                 ts, ts.n_alive, camera_only)
    gated_j = jtrain._gate_grads(g_j, js, js.n_alive, camera_only)
    for name, gt, gj in zip(jp._fields, gated_t, gated_j):
        close_normalized(gt.numpy(), np.asarray(gj), 1e-3, name)
    assert np.abs(np.asarray(g_j.pose)).max() > 0


def run_both(p, s, tg, intr, iters, **cfg_kw):
    dyn = dict(lr=1e-2, lr_camera=1e-3, num_points=300, densify_occ_percent=0.5)
    jcfg = jtrain.StageConfig(W=W, H=H, iterations=iters, render=JConfig(**RC), **cfg_kw)
    tcfg = ttrain.StageConfig(W=W, H=H, iterations=iters, render=TConfig(**RC), **cfg_kw)
    jp, js, jt = jax_side(p, s, tg)
    fn = jax.jit(functools.partial(
        jtrain.train_stage, cfg=jcfg,
        dyn=jtrain.StageDynamics.make(weights=jlosses.LossWeights.make(**WEIGHTS), **dyn)))
    out_j = fn(jp, js, jt, jnp.asarray(intr), jax.random.PRNGKey(0))
    tp, ts, tt = torch_side(p, s, tg)
    out_t = ttrain.train_stage(tp, ts, tt, torch.from_numpy(intr),
                               torch.Generator().manual_seed(0), tcfg,
                               ttrain.StageDynamics(weights=tlosses.LossWeights(**WEIGHTS), **dyn),
                               device="cpu")
    return out_j, out_t


def assert_params_close(pt, pj, iters, lr):
    for name in pj._fields:
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        diff = np.abs(a - b)
        assert diff.max() <= 3 * iters * lr, (name, diff.max())
        bulk = diff <= 1e-4 + 1e-4 * np.abs(b)
        assert bulk.mean() >= 0.99, (name, bulk.mean())


@pytest.mark.parametrize("camera_only", [True, False])
def test_stage_matches_jax(camera_only):
    """A short stage, densify off: the camera-only stage on a scene with a
    previous frame (coverage, still and flow terms live), the full stage
    from a first frame."""
    p, s, tg, intr = start(1, with_last=camera_only)
    iters = 8
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, iters, camera_only=camera_only)
    lr = 1e-3 if camera_only else 1e-2
    assert_params_close(pt, pj, iters, lr)
    for k in ("rgb", "depth", "total"):
        np.testing.assert_allclose(float(it["metrics"][k]), float(ij["metrics"][k]),
                                   rtol=1e-3, err_msg=k)
    assert it["loss_trace"].shape == (iters,)
    assert float(it["loss_trace"][-1]) == pytest.approx(float(it["metrics"]["total"]))
    np.testing.assert_allclose(it["rgb"].numpy(), np.asarray(ij["rgb"]), atol=2e-3)
    if camera_only:  # attributes frozen, pose moved
        np.testing.assert_array_equal(pt.xyz.numpy(), p["xyz"])
        assert np.abs(pt.pose.numpy() - p["pose"]).max() > 0
    else:  # finalize_stage bookkeeping
        assert int(st.last_num) == int(st.n_alive) == int(sj.last_num)
        agree = (st.still_mask.numpy() == np.asarray(sj.still_mask)).mean()
        assert agree >= 0.99, agree


def test_occ_densify_stage_n_alive_matches_jax():
    """Occluded-region densify at iteration 0: the count is deterministic
    (num_points * mask_ratio * percent), so n_alive is EQUAL across packages
    although the two draw different uniforms."""
    p, s, tg, intr = start(2)
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, 4, densify_occ=True, max_densify=64)
    n0 = int(s["n_alive"])
    assert int(it["n_alive"]) == int(ij["n_alive"]) > n0
    assert int(st.n_alive) == int(sj.n_alive)
    assert torch.isfinite(it["loss_trace"]).all()


def test_propagate_and_finalize_match_jax():
    p, s, tg, intr = start(3, with_last=True)
    jp, js, jt = jax_side(p, s, tg)
    tp, ts, tt = torch_side(p, s, tg)
    out_j = jtrain.propagate_moving_points(jp, js, jt, jnp.asarray(intr), W, H)
    out_t = ttrain.propagate_moving_points(tp, ts, tt, torch.from_numpy(intr), W, H)
    np.testing.assert_allclose(out_t.xyz.numpy(), np.asarray(out_j.xyz), atol=1e-5)
    assert (np.asarray(out_j.xyz) != p["xyz"]).any()
    uv = np.random.default_rng(4).uniform([-5, -5], [W + 5, H + 5], (C, 2)).astype(np.float32)
    dep = np.random.default_rng(5).uniform(1, 3, (C, 1)).astype(np.float32)
    fj = jtrain.finalize_stage(jnp.asarray(uv), jnp.asarray(dep), jp, js, jt.move_mask,
                               js.n_alive, W, H)
    ft = ttrain.finalize_stage(torch.from_numpy(uv), torch.from_numpy(dep), tp, ts,
                               tt.move_mask, ts.n_alive, W, H)
    for k in fj._fields:
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)),
                                      err_msg=k)


@pytest.mark.parametrize("camera_only", [False, True])
def test_rebin_stage_matches_jax(camera_only):
    """rebin_every=3 against the JAX package's amortized-rebinning loop,
    densify off, held as test_stage_matches_jax holds the plain stage."""
    p, s, tg, intr = start(4, with_last=camera_only)
    iters = 8
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, iters, camera_only=camera_only,
                                          rebin_every=3)
    assert_params_close(pt, pj, iters, 1e-3 if camera_only else 1e-2)
    for k in ("rgb", "depth", "total"):
        np.testing.assert_allclose(float(it["metrics"][k]), float(ij["metrics"][k]),
                                   rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(it["rgb"].numpy(), np.asarray(ij["rgb"]), atol=2e-3)
    assert it["loss_trace"].shape == (iters,)


def test_rebin_stage_with_error_densify_matches_jax():
    """The rebinning loop with one error densify after iteration 3 (the
    lists are rebuilt right after it): n_alive equal."""
    p, s, tg, intr = start(5)
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, 7, rebin_every=3,
                                          densify_interval=4, densify_times=1, max_densify=16)
    n0 = int(s["n_alive"])
    assert int(it["n_alive"]) == int(ij["n_alive"]) == n0 + 16
    assert int(st.last_num) == int(sj.last_num)
    assert torch.isfinite(it["loss_trace"]).all()


def test_rebin_lists_rebuilt_after_densify():
    """The lists are rebuilt right after a densify. With an occ densify
    after iteration 0, rebin_every=3's iterations 0 and 1 run on the lists
    that rebin_every=1 bins in its own forward (the same parameters, the
    same generator), so the two loss traces agree there to float rounding;
    lists left from before the densify would miss the new points in
    iteration 1."""
    p, s, tg, intr = start(8)
    dyn = ttrain.StageDynamics(weights=tlosses.LossWeights(**WEIGHTS), lr=1e-2,
                               lr_camera=1e-3, num_points=300, densify_occ_percent=0.5)
    infos = []
    for rebin_every in (3, 1):
        tp, ts, tt = torch_side(p, s, tg)
        cfg = ttrain.StageConfig(W=W, H=H, iterations=4, render=TConfig(**RC),
                                 rebin_every=rebin_every, densify_occ=True, max_densify=64)
        infos.append(ttrain.train_stage(tp, ts, tt, torch.from_numpy(intr),
                                        torch.Generator().manual_seed(0), cfg, dyn,
                                        device="cpu")[2])
    assert int(infos[0]["n_alive"]) == int(infos[1]["n_alive"]) > int(s["n_alive"])
    np.testing.assert_allclose(infos[0]["loss_trace"][:2].numpy(),
                               infos[1]["loss_trace"][:2].numpy(), rtol=1e-6)


def assert_snapshots_close(got, want):
    assert set(got) == set(want) == {"rgb", "depth_map", "center"}
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape, k
        close = np.abs(g.astype(int) - w.astype(int)) <= 2
        assert close.mean() >= 0.99, (k, close.mean())


def test_snapshot_stage_matches_jax():
    """snapshot_every=5 over 12 iterations (chunks of 5, 5, 2) against the
    JAX package's snapshot scan, densify off: the stage's outputs come
    from the last in-loop forward."""
    p, s, tg, intr = start(6)
    iters = 12
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, iters, snapshot_every=5)
    assert it["snapshots"]["rgb"].shape == (3, H, W, 3)
    assert_snapshots_close(it["snapshots"], ij["snapshots"])
    assert_params_close(pt, pj, iters, 1e-2)
    np.testing.assert_allclose(it["rgb"].numpy(), np.asarray(ij["rgb"]), atol=2e-3)
    np.testing.assert_allclose(it["uv"].numpy(), np.asarray(ij["uv"]), atol=1e-3)
    np.testing.assert_allclose(float(it["metrics"]["total"]), float(ij["metrics"]["total"]),
                               rtol=1e-3)
    # no final forward: the reported total is the last iteration's loss
    assert float(it["loss_trace"][-1]) == pytest.approx(float(it["metrics"]["total"]))
    agree = (st.still_mask.numpy() == np.asarray(sj.still_mask)).mean()
    assert agree >= 0.99, agree


def test_snapshot_stage_with_occ_densify_matches_jax():
    """The snapshot path's in-loop occ densify at iteration 0: n_alive
    equal, and the densified points appear in the center snapshots."""
    p, s, tg, intr = start(7)
    (pj, sj, ij), (pt, st, it) = run_both(p, s, tg, intr, 6, snapshot_every=5,
                                          densify_occ=True, max_densify=64)
    n0 = int(s["n_alive"])
    assert int(it["n_alive"]) == int(ij["n_alive"]) > n0
    assert int(st.n_alive) == int(sj.n_alive)
    assert it["snapshots"]["center"].shape == (2, H, W, 3)
    assert torch.isfinite(it["loss_trace"]).all()
