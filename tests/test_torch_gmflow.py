"""Port parity: GMFlow (gflow_tpu_torch.models.unimatch) against the JAX
package's on the CPU, at the small config of
tests/test_gmflow_full_torch_parity.py (32 channels, 2 transformer
layers, 2 refinements, splits (2, 4), so odd layers take the shifted
window mask). One seeded released-layout state dict goes to the port as
it is (load_state_dict(strict=True)) and to the JAX model through
gflow_tpu.models.unimatch.convert.convert_state_dict.

Tolerances: the flow atol 5e-4 / rtol 1e-3, as the JAX package's replica
test (float32 sums in another order through 2 scales and 2 refinements;
the measured gap is ~3e-6 on |flow| ~7); the parts 1e-5; the occlusion maps
of forward_backward_consistency equal; weight carries bit-equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from gflow_tpu.models.unimatch import convert as jconvert
from gflow_tpu.models.unimatch import gmflow as jg
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.unimatch import convert, gmflow
from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, forward_backward_consistency

FC, NLAYERS, REFINE = 32, 2, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: tier-1 runs six pytest workers on a shared
    CPU, where torch's per-op threads wait on one another (the 700-step
    alignment took 35 s with 8 threads and 2.3 s with 1 beside six busy
    processes). The prior-prep test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SMALL = dict(feature_channels=FC, num_transformer_layers=NLAYERS, num_reg_refine=REFINE,
             attn_splits_list=(2, 4))
ATOL, RTOL = 5e-4, 1e-3


def small_state_dict(seed=0):
    """Seeded released-layout weights for the small config, x0.5 as the JAX
    package's replica test scales its torch init."""
    return seeded_state_dict(convert.expected_torch_keys(NLAYERS, FC, 4), seed=seed, scale=0.5)


def jax_params(sd):
    flat = jconvert.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                       num_layers=NLAYERS)
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def port_model(sd):
    model = GMFlow(GMFlowConfig(**SMALL)).eval()
    model.load_state_dict(sd, strict=True)
    return model


def images(seed=2, H=64, W=96):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def case():
    """The weights, the inputs and the JAX model's flow, computed once."""
    sd = small_state_dict()
    a, b = images()
    want = jg.GMFlow(jg.GMFlowConfig(**SMALL)).apply(jax_params(sd), jnp.asarray(a),
                                                     jnp.asarray(b))
    return sd, a, b, np.asarray(want)


def port_flow(model, a, b):
    with torch.inference_mode():
        return model(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_full_model_matches_jax(case):
    sd, a, b, want = case
    got = port_flow(port_model(sd), a, b)
    assert got.shape == want.shape == (1, 64, 96, 2)
    assert np.abs(want).max() > 1.0  # the flow is not trivially zero
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_converted_npz_carries_into_the_port(case, tmp_path):
    """The JAX package's converted .npz -> the port's state dict (the
    transposes inverted, bit-equal) -> the JAX flow."""
    sd, a, b, want = case
    path = tmp_path / "flow.npz"
    jconvert.save_npz(jconvert.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                                  num_layers=NLAYERS), str(path))
    carried = convert.load_weights(str(path))
    assert set(carried) == set(sd) and all(torch.equal(carried[k], sd[k]) for k in sd)
    cfg = convert.config_for_state_dict(carried, attn_splits_list=(2, 4),
                                        num_reg_refine=REFINE)
    assert cfg == GMFlowConfig(**SMALL)
    model = GMFlow(cfg).eval()
    model.load_state_dict(carried, strict=True)
    np.testing.assert_allclose(port_flow(model, a, b), want, atol=ATOL, rtol=RTOL)


def test_released_pth_loads_strict(tmp_path):
    """A released-layout checkpoint ({"model": state dict}, with the
    non-refine upsampler the flow model does not carry) loads strictly at
    the released width; a missing key fails loudly."""
    shapes = convert.expected_torch_keys()
    sd = seeded_state_dict(shapes, seed=1)
    extra = {"upsampler.0.weight": torch.zeros(256, 130, 3, 3)}
    torch.save({"model": {**sd, **extra}, "step": 10}, tmp_path / "gmflow.pth")
    loaded = convert.load_weights(tmp_path / "gmflow.pth")
    assert set(loaded) == set(shapes)
    assert convert.config_for_state_dict(loaded) == GMFlowConfig()
    model = GMFlow(GMFlowConfig())
    model.load_state_dict(loaded, strict=True)
    assert set(model.state_dict()) == set(shapes)
    assert all(tuple(v.shape) == tuple(shapes[k]) for k, v in model.state_dict().items())
    del loaded["refine.gru.convz1.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        GMFlow(GMFlowConfig()).load_state_dict(loaded, strict=True)


def test_forward_backward_consistency_matches_jax():
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    fwd = np.stack([3 * np.sin(xx / 7), 2 * np.cos(yy / 5)], -1)[None].repeat(2, 0)
    fwd = fwd.astype(np.float32)
    bwd = (-fwd + rng.normal(0, 0.6, fwd.shape)).astype(np.float32)
    want = jg.forward_backward_consistency(jnp.asarray(fwd), jnp.asarray(bwd))
    got = forward_backward_consistency(torch.from_numpy(fwd), torch.from_numpy(bwd))
    for g, w in zip(got, want):
        assert 0.05 < float(g.mean()) < 0.95
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_correlations_and_sampling_match_jax():
    """The parameter-free parts: bilinear sampling with zero padding, the
    flow-conditioned local correlation (out-of-image taps included), the
    masked local softmax, the shifted-window mask and the sine embedding."""
    rng = np.random.default_rng(4)
    f0 = rng.normal(size=(2, 12, 16, 8)).astype(np.float32)
    f1 = rng.normal(size=(2, 12, 16, 8)).astype(np.float32)
    flow = rng.normal(0, 4, (2, 12, 16, 2)).astype(np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    grid = np.asarray(jg._coords_grid(2, 12, 16))
    pairs = [
        (gmflow._bilinear_sample(t(f1), t(grid + flow)), jg._bilinear_sample(j(f1), j(grid + flow))),
        (gmflow.local_correlation_with_flow(t(f0), t(f1), t(flow), 4),
         jg.local_correlation_with_flow(j(f0), j(f1), j(flow), 4)),
        (gmflow.local_correlation_softmax(t(f0), t(f1), 2), jg.local_correlation_softmax(j(f0), j(f1), 2)),
        (gmflow.global_correlation_softmax(t(f0), t(f1)), jg.global_correlation_softmax(j(f0), j(f1))),
        (gmflow.shift_window_attn_mask(12, 16, 2), jg.shift_window_attn_mask(12, 16, 2)),
        (gmflow.position_embedding_sine(6, 8, 32), jg.position_embedding_sine(6, 8, 32)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_upsample_and_refine_free_path_match_jax():
    """Convex upsampling (the mask's 9-neighbourhood is its major channel
    axis) and the num_reg_refine=0 model, whose upsampler the JAX
    converter does not map: the JAX params are built from the same arrays
    by hand."""
    rng = np.random.default_rng(5)
    flow = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 4, 5, 9 * 16)).astype(np.float32)
    got = gmflow.upsample_flow_with_mask(torch.from_numpy(flow).permute(0, 3, 1, 2),
                                         torch.from_numpy(mask).permute(0, 3, 1, 2), 4)
    want = jg.upsample_flow_with_mask(jnp.asarray(flow), jnp.asarray(mask), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)

    cfg = dict(SMALL, num_reg_refine=0, num_transformer_layers=1)
    model = GMFlow(GMFlowConfig(**cfg)).eval()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes, seed=6, scale=0.5)
    model.load_state_dict(sd, strict=True)
    body = {k: v.numpy() for k, v in sd.items() if not k.startswith(("upsampler.", "refine"))}
    flat = jconvert.convert_state_dict(body, num_layers=1, strict=False)
    for i in (0, 2):
        flat[f"upsampler_{i}/kernel"] = sd[f"upsampler.{i}.weight"].numpy().transpose(2, 3, 1, 0)
        flat[f"upsampler_{i}/bias"] = sd[f"upsampler.{i}.bias"].numpy()
    params = {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                        for k, v in flat.items()})}
    a, b = images(seed=7, H=32, W=64)
    want = jg.GMFlow(jg.GMFlowConfig(**cfg)).apply(params, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(port_flow(model, a, b), np.asarray(want), atol=ATOL, rtol=RTOL)
