"""Port parity: densify_by_pixels and the post-densify Adam reset
(gflow_tpu_torch.opt.densify vs gflow_tpu.opt.densify), fed JAX's own
uniforms, and the hand-written Adam update.

Tolerances: n_alive and densify_num EXACT. With the occ-style uniform
error map the CDF is integer-valued, so both packages pick the same pixels
and the new parameters agree to f32 rounding (1e-5). With a float error
map the two f32 cumulative sums round differently, which can move a draw
sitting on a CDF step to the neighbouring pixel: at least 97% of the drawn
rows must match."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core.camera import default_intrinsics, pose_to_extr
from gflow_tpu.opt import densify as jdens
from gflow_tpu.opt import state as jstate
from gflow_tpu_torch import convert
from gflow_tpu_torch.opt import densify as tdens
from gflow_tpu_torch.opt import state as tstate

W, H, C = 40, 30, 600


def inputs(seed, n_alive=300):
    rng = np.random.default_rng(seed)
    p = dict(
        xyz=rng.normal(size=(C, 3)), scale=rng.uniform(0, 0.1, (C, 3)),
        rotate=rng.normal(size=(C, 4)), opacity=rng.normal(size=(C, 1)),
        rgb=rng.normal(size=(C, 3)),
        pose=np.array([0.05, -0.02, 0.01, 1.0, 0.1, 0.0, -0.05]),
        depth_ab=np.array([1.0, 0.0]))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    img = rng.uniform(0.05, 0.95, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, (H, W, 1)).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[5:25, 3:30] = True
    err = rng.uniform(0, 0.1, (H, W)).astype(np.float32)
    return p, np.int32(n_alive), img, depth, mask, err


def run_both(p, n_alive, emap, mask, img, depth, num_points, percent, max_densify):
    intr = np.array(default_intrinsics(W, H))
    u = jax.random.uniform(jax.random.PRNGKey(3), (max_densify,))
    jp = jstate.Params(**{k: jnp.asarray(v) for k, v in p.items()})
    extr_j = pose_to_extr(jp.pose)
    out_j = jdens.densify_by_pixels(
        jp, jnp.asarray(n_alive), jnp.asarray(emap), jnp.asarray(mask), jnp.asarray(img),
        jnp.asarray(depth), jnp.asarray(intr), extr_j, jnp.float32(num_points),
        jnp.float32(percent), jax.random.PRNGKey(3), max_densify)
    tp = convert.params_from_numpy(p, "cpu")
    out_t = tdens.densify_by_pixels(
        tp, torch.tensor(n_alive), torch.from_numpy(emap), torch.from_numpy(mask),
        torch.from_numpy(img), torch.from_numpy(depth), torch.from_numpy(intr),
        torch.from_numpy(np.array(extr_j)), num_points, percent,
        torch.from_numpy(np.array(u)))
    return out_j, out_t


@pytest.mark.parametrize("num_points,percent,n_alive", [(300, 0.5, 300), (3000, 1.0, 550)])
def test_occ_densify_matches_jax_exactly(num_points, percent, n_alive):
    """Second case: the count is capped by the free capacity (C - n_alive)."""
    p, n0, img, depth, mask, _ = inputs(0, n_alive)
    ones = np.ones((H, W), np.float32)
    (pj, nj, dj), (pt, nt, dt) = run_both(p, n0, ones, mask, img, depth, num_points,
                                          percent, 128)
    assert int(nt) == int(nj) and int(dt) == int(dj) > 0
    for k in pj._fields:
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # untouched beyond the new slots
    np.testing.assert_array_equal(pt.xyz.numpy()[int(nt):], p["xyz"][int(nt):])


def test_error_densify_matches_jax():
    p, n0, img, depth, _, err = inputs(1)
    mask = err > 0.05
    (pj, nj, dj), (pt, nt, dt) = run_both(p, n0, err, mask, img, depth, 300, 1.0, 256)
    assert int(nt) == int(nj) and int(dt) == int(dj) > 50
    rows = slice(int(n0), int(nt))
    same = np.all(np.isclose(pt.xyz.numpy()[rows], np.asarray(pj.xyz)[rows],
                             rtol=1e-5, atol=1e-5), axis=1)
    assert same.mean() >= 0.97, same.mean()
    for k in ("scale", "rgb"):
        a, b = getattr(pt, k).numpy()[rows][same], np.asarray(getattr(pj, k))[rows][same]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=k)


def test_empty_mask_adds_nothing():
    p, n0, img, depth, _, err = inputs(2)
    none = np.zeros((H, W), bool)
    (pj, nj, dj), (pt, nt, dt) = run_both(p, n0, err, none, img, depth, 300, 1.0, 64)
    assert int(dt) == int(dj) == 0 and int(nt) == int(n0)
    for k in pj._fields:
        np.testing.assert_array_equal(getattr(pt, k).numpy(), p[k])


def test_adam_and_post_densify_reset_match_jax():
    rng = np.random.default_rng(4)
    p, *_ = inputs(3)
    jp = jstate.Params(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = convert.params_from_numpy(p, "cpu")
    jo, to = jstate.init_opt_state(jp), tstate.init_opt_state(tp)
    for _ in range(10):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        jg = jstate.Params(**{k: jnp.asarray(v) for k, v in grads.items()})
        jp, jo = jstate.adam_update(jp, jg, jo, 1e-2, 1e-3, 5e-3)
        tp, to = tstate.adam_update(tp, convert.params_from_numpy(grads, "cpu"), to,
                                    1e-2, 1e-3, 5e-3)
    # both take the bias corrections in float32: after 10 steps the moments
    # are equal and the parameters (|p| < 4.1) agree to 4.8e-7, two f32 ulps
    # below |p| = 4 (measured 1.2e-7)
    for k in jp._fields:
        np.testing.assert_array_equal(getattr(to.m, k).numpy(), np.asarray(getattr(jo.m, k)))
        np.testing.assert_array_equal(getattr(to.v, k).numpy(), np.asarray(getattr(jo.v, k)))
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=0, atol=4.8e-7, err_msg=k)
    reset = tdens.reset_opt_after_densify(to, tp)
    assert reset.post_densify and reset.step == 0
    assert all(float(m.abs().max()) == 0 for m in reset.m)
    assert bool(jdens.reset_opt_after_densify(jo, jp).post_densify)
