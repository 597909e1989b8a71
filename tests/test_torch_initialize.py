"""Port parity: init_params_from_image with a shared NumPy seed, the
sampling helpers, and the convert.py carry-over.

Tolerances: sampling runs on the host with NumPy in both packages, so the
chosen pixels, scales, colors and rotations are IDENTICAL; xyz comes out
of a (N, 3) x (3, 3) product that the two libraries may sum in another
order (1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core import sampling as jsamp
from gflow_tpu.opt import state as jstate
from gflow_tpu.opt.initialize import init_params_from_image as j_init
from gflow_tpu_torch import convert
from gflow_tpu_torch.core import sampling as tsamp
from gflow_tpu_torch.opt import state as tstate
from gflow_tpu_torch.opt.initialize import init_params_from_image as t_init


def image(seed, H=40, W=56):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.02, 0.98, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    return img, depth


@pytest.mark.parametrize("with_mask", [False, True])
def test_init_identical_with_shared_seed(with_mask):
    img, depth = image(0)
    H, W = depth.shape
    mask = None
    if with_mask:
        mask = np.zeros((H, W), bool)
        mask[:10] = True
    intr = np.asarray([60.0, 60.0, W / 2, H / 2], np.float32)
    ang = 0.1
    extr = np.asarray([[np.cos(ang), 0, np.sin(ang), 0.1], [0, 1, 0, -0.2],
                       [-np.sin(ang), 0, np.cos(ang), 0.3]], np.float32)
    pj, nj = j_init(img, depth, 500, 1024, intr, extr, mask=mask, drop_to=400,
                    rng=np.random.default_rng(7))
    pt, nt = t_init(img, depth, 500, 1024, intr, extr, mask=mask, drop_to=400,
                    rng=np.random.default_rng(7), device="cpu")
    assert nt == nj and 0 < nt <= 400
    for k in ("scale", "rotate", "depth_ab"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                      err_msg=k)
    for k in ("xyz", "opacity", "rgb", "pose"):
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_sampling_helpers_identical():
    img, depth = image(1)
    np.testing.assert_array_equal(tsamp.gradient_probability_map(img),
                                  jsamp.gradient_probability_map(img))
    a = tsamp.complex_texture_sampling(img, depth, 300, rng=np.random.default_rng(2))
    b = jsamp.complex_texture_sampling(img, depth, 300, rng=np.random.default_rng(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_convert_roundtrip_both_packages():
    """Params / FrameState / Targets cross between the packages through
    plain dicts of NumPy arrays keyed by the JAX field names."""
    rng = np.random.default_rng(3)
    C = 64
    p = jstate.Params(xyz=jnp.asarray(rng.normal(size=(C, 3)), jnp.float32),
                      scale=jnp.ones((C, 3)), rotate=jnp.ones((C, 4)),
                      opacity=jnp.zeros((C, 1)), rgb=jnp.zeros((C, 3)),
                      pose=jnp.asarray([0, 0, 0, 1, 0, 0, 0], jnp.float32),
                      depth_ab=jnp.asarray([1.0, 0.0]))
    tp = convert.params_from_numpy(p._asdict(), "cpu")
    back = convert.params_to_numpy(tp)
    assert set(back) == set(jstate.Params._fields)
    for k, v in p._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    s = jstate.init_frame_state(C)._replace(n_alive=jnp.asarray(17, jnp.int32))
    ts = convert.frame_state_from_numpy(s._asdict(), "cpu")
    assert ts.n_alive.dtype == torch.int32 and int(ts.n_alive) == 17
    assert ts.still_mask.dtype == torch.bool
    for k, v in convert.frame_state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(s, k)))
    ref = tstate.init_frame_state(C, device="cpu")
    for k in tstate.FrameState._fields:
        assert getattr(ref, k).shape == getattr(ts, k).shape
    tg = {"image": np.zeros((4, 5, 3), np.float32), "depth": np.ones((4, 5, 1), np.float32),
          "flow": np.zeros((4, 5, 2), np.float32), "move_mask": np.zeros((4, 5), bool),
          "occ_mask": np.ones((4, 5), bool)}
    tt = convert.targets_from_numpy(tg, "cpu")
    tg["depth"][:] = 7.0  # the carried-over tensors do not alias the input
    assert float(tt.depth.max()) == 1.0
    assert convert.targets_to_numpy(tt)["occ_mask"].all()


def test_init_frame_state_matches_jax():
    C = 48
    ts = tstate.init_frame_state(C, device="cpu")
    for k, v in jstate.init_frame_state(C)._asdict().items():
        got = getattr(ts, k).numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
