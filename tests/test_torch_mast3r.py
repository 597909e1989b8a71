"""Port parity: MASt3R (gflow_tpu_torch.models.mast3r: vit.py and
dpt_head.py) against the JAX package's on the CPU, at the small widths of
tests/test_mast3r_full_torch_parity.py (encoder 32, decoder 24, 2 heads,
depth 2, patch 16), on a 3x2 token grid (odd, so the DPT crops run). One
seeded released-layout state dict goes to the port as it is and to the
JAX model through gflow_tpu.models.mast3r.convert.convert_state_dict, for
both head families: catmlp+dpt, and linear with and without the
descriptor head (which the JAX converter does not map: its two leaves are
added by hand).

Tolerances: outputs atol 2e-4 / rtol 1e-3, as the JAX package's replica
test; RoPE and the align-corners resize 1e-5; weight carries bit-equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from gflow_tpu.models.mast3r import convert as jconvert
from gflow_tpu.models.mast3r import dpt_head as jdpt
from gflow_tpu.models.mast3r import vit as jvit
from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert, dpt_head, vit
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = dict(enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=24, dec_depth=2, dec_heads=2,
             desc_dim=6)
ATOL, RTOL = 2e-4, 1e-3
HEADS = [("catmlp+dpt", True), ("linear", True), ("linear", False)]


def small_case(head, with_desc, seed=0):
    """(config, seeded released-layout state dict, JAX params)."""
    cfg = dict(SMALL, head=head, with_desc=with_desc)
    shapes = convert.expected_torch_keys(2, 2, 32, 24, 16, head, 6)
    if head == "linear" and with_desc:
        for i in (1, 2):
            shapes[f"downstream_head{i}.desc_proj.weight"] = (7 * 16 * 16, 24)
            shapes[f"downstream_head{i}.desc_proj.bias"] = (7 * 16 * 16,)
    # x0.3, as the JAX package's replica test: exp / expm1 overflow otherwise
    sd = seeded_state_dict(shapes, seed=seed, scale=0.3)
    for k in [k for k in sd if "refinenet4.resConfUnit1" in k]:
        del sd[k]  # dead weights: the loader drops them (see test_released_pth_loads_strict)
    npsd = {k: v.numpy() for k, v in sd.items()}
    flat = jconvert.convert_state_dict(npsd, 2, 2, strict=not with_desc or head != "linear")
    for k in [k for k in npsd if ".desc_proj." in k]:
        i, leaf = k.split(".")[0], k.split(".")[-1]
        flat[f"{i}/desc_proj/{'kernel' if leaf == 'weight' else 'bias'}"] = (
            npsd[k].T if leaf == "weight" else npsd[k])
    params = {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                        for k, v in flat.items()})}
    return cfg, sd, params, flat


def views(seed=1, H=48, W=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]


def port_outputs(model, a, b):
    with torch.inference_mode():
        return model(torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("head,with_desc,hw", [(*h, (48, 32)) for h in HEADS]
                         + [("catmlp+dpt", True, (44, 40))])
def test_model_matches_jax(head, with_desc, hw):
    """44x40 is no multiple of the patch: the JAX model's 'SAME' patch
    convolution pads it, and so does the port's."""
    cfg, sd, params, _ = small_case(head, with_desc)
    model = Mast3rModel(Mast3rConfig(**cfg)).eval()
    model.load_state_dict(sd, strict=True)
    a, b = views(H=hw[0], W=hw[1])
    got = port_outputs(model, a, b)
    want = jvit.Mast3rModel(jvit.Mast3rConfig(**cfg)).apply(params, jnp.asarray(a),
                                                           jnp.asarray(b))
    keys = {"pts3d", "conf"} | ({"desc", "desc_conf"} if with_desc else set())
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].shape == w[k].shape and g[k].shape[1:3] == hw
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=k)
    assert float(torch.std(got[0]["pts3d"])) > 1e-3  # not a constant map


def test_converted_npz_carries_into_the_port(tmp_path):
    """The JAX package's converted .npz (catmlp+dpt) -> the port's state
    dict, bit-equal, which loads strictly and gives the JAX outputs."""
    cfg, sd, params, flat = small_case("catmlp+dpt", True, seed=2)
    path = tmp_path / "mast3r.npz"
    jconvert.save_npz(flat, str(path))
    carried = convert.load_weights(str(path))
    assert set(carried) == set(sd) and all(torch.equal(carried[k], sd[k]) for k in sd)
    got_cfg = convert.config_for_state_dict(carried)
    assert (got_cfg.head, got_cfg.enc_depth, got_cfg.dec_dim, got_cfg.desc_dim) == (
        "catmlp+dpt", 2, 24, 6)
    model = Mast3rModel(Mast3rConfig(**cfg)).eval()
    model.load_state_dict(carried, strict=True)
    a, b = views(seed=3)
    got = port_outputs(model, a, b)
    want = jvit.Mast3rModel(jvit.Mast3rConfig(**cfg)).apply(params, jnp.asarray(a),
                                                           jnp.asarray(b))
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head", ["catmlp+dpt", "linear"])
def test_released_pth_loads_strict(tmp_path, head):
    """A released-layout checkpoint at the released widths (depth cut to
    2 + 2 blocks to keep the test small), with the keys
    the model never uses (mask_token, prediction_head.*, and for DPT the
    dead refinenet4.resConfUnit1): the loader drops exactly
    _IGNORED_PREFIXES and the model loads strictly; an alien key does not
    load."""
    shapes = convert.expected_torch_keys(enc_depth=2, dec_depth=2, head=head)
    sd = seeded_state_dict(shapes, seed=4, scale=0.3)
    extra = {"mask_token": torch.zeros(1, 1, 1024), "prediction_head.proj.weight": torch.zeros(4, 4)}
    torch.save({"model": {**sd, **extra}, "args": "AsymmetricMASt3R(...)"}, tmp_path / "m.pth")
    loaded = convert.load_weights(tmp_path / "m.pth")
    dead = {k for k in shapes if "refinenet4.resConfUnit1" in k}
    assert bool(dead) == (head == "catmlp+dpt")
    assert set(loaded) == set(shapes) - dead
    cfg = convert.config_for_state_dict(loaded)
    assert cfg == Mast3rConfig(head=head, with_desc=False, enc_depth=2, dec_depth=2)
    model = Mast3rModel(cfg)
    model.load_state_dict(loaded, strict=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, s in shapes.items() if k not in dead}
    loaded["enc_blocks.9.norm1.weight"] = torch.ones(1024)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(loaded, strict=True)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.stack([np.repeat(np.arange(3), 4), np.tile(np.arange(4), 3)], 1)
    got = vit.rope_2d(torch.from_numpy(q), torch.from_numpy(pos), 100.0)
    want = jvit.rope_2d(jnp.asarray(q), jnp.asarray(pos), 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,out", [((5, 7), (9, 13)), ((1, 6), (1, 11)), ((4, 1), (7, 3)),
                                       ((6, 6), (1, 4)), ((3, 4), (3, 4))])
def test_bilinear_resize_ac_matches_jax(shape, out):
    """align_corners=True, including a single input or output row."""
    x = np.random.default_rng(6).normal(size=(2, *shape, 3)).astype(np.float32)
    got = dpt_head.bilinear_resize_ac(torch.from_numpy(x).permute(0, 3, 1, 2), *out)
    want = jdpt.bilinear_resize_ac(jnp.asarray(x), *out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_head_pieces_match_jax():
    """pixel_shuffle_tokens and the 'exp' regression reg_dense_pts3d."""
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 6, 5 * 4 * 4)).astype(np.float32)
    got = dpt_head.pixel_shuffle_tokens(torch.from_numpy(y), 2, 3, 5, 4)
    want = jdpt.pixel_shuffle_tokens(jnp.asarray(y), 2, 3, 5, 4)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    xyz = rng.normal(0, 2, (2, 5, 4, 3)).astype(np.float32)
    got = dpt_head.reg_dense_pts3d(torch.from_numpy(xyz).permute(0, 3, 1, 2))
    want = jdpt.reg_dense_pts3d(jnp.asarray(xyz))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5)
