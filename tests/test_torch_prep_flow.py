"""Port parity: prep_flow (gflow_tpu_torch.pipeline.prep_flow) against the
JAX package's main on the CPU, on a 4-frame 48x64 sequence (padded to
64x64) with an injected tiny GMFlow (32 channels, 1 layer, 1 refinement,
splits (2, 4)) and one seeded released-layout state dict (the JAX model
takes it through convert_state_dict). Also the CLI, through --checkpoint
with a released-layout .pth and with the JAX package's .npz, the missing
weights error, and mesh_devices (pairs batched over 4 CPU replicas)
against the unbatched run.

Tolerances: .flo values atol 5e-4 / rtol 1e-3 (tests/test_torch_gmflow.py);
the occlusion PNGs equal, but for pixels whose consistency test sits
within 1e-3 of its bound (the flows differ by float32 rounding)."""
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from gflow_tpu.models.unimatch import convert as jconvert
from gflow_tpu.models.unimatch.gmflow import GMFlow as JaxGMFlow, GMFlowConfig as JaxConfig
from gflow_tpu.pipeline import prep_flow as jax_prep
from gflow_tpu_torch.core.io import imread, imwrite, read_flow
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert
from gflow_tpu_torch.models.unimatch.gmflow import consistency_terms
from gflow_tpu_torch.pipeline import prep_flow
from gflow_tpu_torch.utils.cli import run_cli
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(feature_channels=32, num_transformer_layers=1, num_reg_refine=1,
            attn_splits_list=(2, 4))


def write_frames(d, n=4, H=48, W=64, seed=0):
    """tests/test_sharded_infer.py's sequence: crops of one random image
    sliding 2 px a frame."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    base = rng.uniform(0, 255, (H, W + 2 * n, 3)).astype(np.uint8)
    for t in range(n):
        imwrite(os.path.join(d, f"{t:05d}.png"), base[:, t * 2: t * 2 + W])
    return str(d)


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(convert.expected_torch_keys(1, 32, 4), seed=0, scale=0.5)


def tiny_model(sd):
    model = GMFlow(GMFlowConfig(**TINY))
    model.load_state_dict(sd, strict=True)
    return model


def outputs(d):
    out = d + "_flow_unimatch"
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(out, "*")))


def assert_same_outputs(d_port, d_jax):
    names = outputs(d_jax)
    assert names == outputs(d_port) and len(names) == 9  # 3 pairs x (2 .flo + occ)
    for name in names:
        a, b = (os.path.join(d + "_flow_unimatch", name) for d in (d_port, d_jax))
        if name.endswith(".flo"):
            np.testing.assert_allclose(read_flow(a), read_flow(b), atol=5e-4, rtol=1e-3)
            continue
        got, want = imread(a), imread(b)
        assert got.shape == want.shape == (48, 64)
        flips = got != want
        if flips.any():
            # only where the test sits on its bound
            stem = os.path.join(d_port + "_flow_unimatch", name[: -len("_occ_bwd.png")])
            fwd, bwd = read_flow(stem + "_pred.flo"), read_flow(stem + "_pred_bwd.flo")
            _, (diff, bound) = consistency_terms(torch.from_numpy(fwd)[None],
                                                 torch.from_numpy(bwd)[None])
            assert float((diff - bound).abs()[0][torch.from_numpy(flips)].max()) < 1e-3


def test_main_matches_jax(tmp_path, weights):
    d_port, d_jax = write_frames(tmp_path / "port"), write_frames(tmp_path / "jax")
    assert prep_flow.main(d_port, model=tiny_model(weights), device="cpu") == (
        d_port + "_flow_unimatch")
    flat = jconvert.convert_state_dict({k: v.numpy() for k, v in weights.items()},
                                       num_layers=1)
    params = {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                        for k, v in flat.items()})}
    jax_prep.main(d_jax, model=JaxGMFlow(JaxConfig(**TINY)), params=params)
    assert_same_outputs(d_port, d_jax)
    fwd = read_flow(os.path.join(d_port + "_flow_unimatch", "00000_pred.flo"))
    assert fwd.shape == (48, 64, 2) and np.isfinite(fwd).all()


def test_cli_reads_pth_and_npz(tmp_path, weights, monkeypatch):
    """--checkpoint with a released-layout .pth, and $GFLOW_UNIMATCH_WEIGHTS
    with the JAX package's .npz: the same flows. The tiny config's splits
    and refinements are not in the weights' shapes, so the CLI's model is
    sized through config_for_state_dict with them patched in."""
    full = convert.config_for_state_dict
    monkeypatch.setattr(convert, "config_for_state_dict",
                        lambda sd, **kw: full(sd, **{**kw, **TINY}))
    pth, npz = tmp_path / "gmflow.pth", tmp_path / "gmflow.npz"
    torch.save({"model": weights}, pth)
    jconvert.save_npz(jconvert.convert_state_dict({k: v.numpy() for k, v in weights.items()},
                                                  num_layers=1), str(npz))
    d1, d2, d3 = (write_frames(tmp_path / s) for s in ("a", "b", "c"))
    run_cli(prep_flow.main, ["--img-dir", d1, "--checkpoint", str(pth), "--device", "cpu"])
    monkeypatch.setenv(prep_flow.CKPT_ENV, str(npz))
    run_cli(prep_flow.main, ["--img-dir", d2, "--device", "cpu"])
    prep_flow.main(d3, model=tiny_model(weights), device="cpu")
    for name in outputs(d3):
        if name.endswith(".flo"):
            ref = read_flow(os.path.join(d3 + "_flow_unimatch", name))
            for d in (d1, d2):
                np.testing.assert_array_equal(read_flow(os.path.join(d + "_flow_unimatch", name)), ref)


def test_missing_weights_and_multi_gpu_raise(tmp_path, monkeypatch):
    monkeypatch.delenv(prep_flow.CKPT_ENV, raising=False)
    d = write_frames(tmp_path / "seq", n=2)
    with pytest.raises(FileNotFoundError, match="GFLOW_UNIMATCH_WEIGHTS"):
        prep_flow.main(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        prep_flow.main(d, checkpoint=str(tmp_path / "absent.pth"), device="cpu")


def test_mesh_devices_match_single(tmp_path, weights):
    """mesh_devices=4 (4 CPU replicas, 6 directed pairs in batches of 4:
    the tail batch padded and its padding dropped) against mesh_devices=0:
    flows within 2e-4 (tests/test_sharded_infer.py:52), occlusions equal."""
    d0, d4 = write_frames(tmp_path / "single"), write_frames(tmp_path / "mesh")
    prep_flow.main(d0, model=tiny_model(weights), mesh_devices=0, device="cpu")
    prep_flow.main(d4, model=tiny_model(weights), mesh_devices=4, device="cpu")
    names = outputs(d0)
    assert names == outputs(d4) and len(names) == 9
    for name in names:
        a, b = (os.path.join(d + "_flow_unimatch", name) for d in (d4, d0))
        if name.endswith(".flo"):
            np.testing.assert_allclose(read_flow(a), read_flow(b), atol=2e-4)
        else:
            np.testing.assert_array_equal(imread(a), imread(b))
