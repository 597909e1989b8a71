"""Port parity: prep_depth (gflow_tpu_torch.pipeline.prep_depth) against the
JAX package's main on the CPU, on a 5-frame 48x64 sequence with injected
tiny models (patch 8, the test_sharded_infer.py widths; both head
families) and one seeded released-layout state dict (x0.3), a logwin-2
graph and the full 500 + 200-step alignment.

Also 44x60 frames (no multiple of the patch: both models pad as 'SAME'),
the CLI through --checkpoint (.pth and the JAX package's .npz), the
output schema, the depth resized back to exactly the frame's size, and
mesh_devices (pairs batched over 4 CPU replicas) against the unbatched
run.

Tolerances (the model outputs agree to ~1e-6, tests/test_torch_mast3r.py,
then 700 Adam steps run in each package): depth and pts3d .npy rtol 1e-3,
camera focal rtol 1e-4, pose atol 1e-3, pp equal; the depth PNGs within
one level of the 256-level turbo table."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from gflow_tpu.models.mast3r import convert as jconvert
from gflow_tpu.models.mast3r.vit import Mast3rConfig as JaxConfig, Mast3rModel as JaxModel
from gflow_tpu.pipeline import prep_depth as jax_prep
from gflow_tpu_torch.core.io import imread, read_camera
from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.pipeline import prep_depth
from gflow_tpu_torch.utils.cli import run_cli
from gflow_tpu_torch.viz.colormap import TURBO
from tests.test_torch_prep_flow import write_frames
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(patch_size=8, enc_dim=32, enc_depth=1, enc_heads=4, dec_dim=16, dec_depth=2,
            dec_heads=4, desc_dim=4)
DIRS = ("_depth_mast3r_s2", "_pts3d_mast3r_s2", "_camera_mast3r_s2")


def tiny(head):
    cfg = dict(TINY, head=head, with_desc=False)
    sd = seeded_state_dict(convert.expected_torch_keys(1, 2, 32, 16, 8, head, 4), seed=0,
                           scale=0.3)
    sd = {k: v for k, v in sd.items() if "refinenet4.resConfUnit1" not in k}
    model = Mast3rModel(Mast3rConfig(**cfg))
    model.load_state_dict(sd, strict=True)
    return cfg, sd, model


def jax_params(sd):
    flat = jconvert.convert_state_dict({k: v.numpy() for k, v in sd.items()}, 1, 2)
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def turbo_level(png):
    """The turbo table's level (0-255) of each pixel of a depth PNG."""
    lut = (np.asarray(TURBO) * 255).astype(np.uint8)
    key = lambda rgb: (rgb[..., 0].astype(np.int64) << 16) | (rgb[..., 1].astype(np.int64) << 8) | rgb[..., 2]
    level = {k: i for i, k in enumerate(key(lut).tolist())}
    assert len(level) == 256
    return np.vectorize(level.__getitem__)(key(png))


def files(seq, sfx):
    return sorted(glob.glob(seq + sfx + "/*"))


def assert_same_outputs(got_seq, want_seq, n=5):
    for sfx in DIRS:
        got, want = files(got_seq, sfx), files(want_seq, sfx)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert len(got) == n * (2 if sfx == DIRS[0] else 1)
        for a, b in zip(got, want):
            if a.endswith(".npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-3)
            elif a.endswith(".png"):
                assert np.abs(turbo_level(imread(a)) - turbo_level(imread(b))).max() <= 1
            else:
                ga, gb = (json.load(open(p)) for p in (a, b))
                assert ga["focal"] == pytest.approx(gb["focal"], rel=1e-4)
                np.testing.assert_allclose(ga["pose"], gb["pose"], atol=1e-3)
                assert ga["pp"] == gb["pp"]


@pytest.mark.parametrize("head,hw", [("linear", (48, 64)), ("catmlp+dpt", (48, 64)),
                                     ("linear", (44, 60))])
def test_main_matches_jax(tmp_path, head, hw):
    cfg, sd, model = tiny(head)
    seq_port = write_frames(tmp_path / "port", n=5, H=hw[0], W=hw[1])
    seq_jax = write_frames(tmp_path / "jax", n=5, H=hw[0], W=hw[1])
    assert prep_depth.main(seq_port, model=model, inference_size=hw[0], winsize=2,
                           device="cpu") == seq_port + DIRS[0]
    jax_prep.main(seq_jax, model=JaxModel(JaxConfig(**cfg)), params=jax_params(sd),
                  inference_size=hw[0], winsize=2)
    assert_same_outputs(seq_port, seq_jax)
    d = np.load(files(seq_port, DIRS[0])[0])
    assert d.shape == hw and np.isfinite(d).all()
    focal, pp, extr = read_camera(files(seq_port, DIRS[2]))
    assert np.isfinite(focal) and pp == [hw[1] // 2, hw[0] // 2] and extr.shape == (5, 3, 4)


def test_cli_reads_pth_and_npz(tmp_path, monkeypatch):
    """A released-layout .pth through --checkpoint and the JAX package's
    .npz through $GFLOW_MAST3R_WEIGHTS: the model is sized from the keys
    (config_for_state_dict: heads = width / 64, so 1 here) and both give
    the same files."""
    _, sd, _ = tiny("linear")
    pth, npz = tmp_path / "m.pth", tmp_path / "m.npz"
    torch.save({"model": {**sd, "mask_token": torch.zeros(1, 1, 32)}}, pth)
    jconvert.save_npz(jconvert.convert_state_dict({k: v.numpy() for k, v in sd.items()}, 1, 2),
                      str(npz))
    a, b = write_frames(tmp_path / "a", n=3), write_frames(tmp_path / "b", n=3)
    run_cli(prep_depth.main, ["--img-dir", a, "--checkpoint", str(pth), "--inference-size", "48",
                              "--device", "cpu"])
    monkeypatch.setenv(prep_depth.CKPT_ENV, str(npz))
    run_cli(prep_depth.main, ["--img-dir", b, "--inference-size", "48", "--device", "cpu"])
    for sfx in DIRS:
        for x, y in zip(files(a, sfx), files(b, sfx)):
            if x.endswith(".npy"):
                np.testing.assert_array_equal(np.load(x), np.load(y))
    monkeypatch.delenv(prep_depth.CKPT_ENV)
    with pytest.raises(FileNotFoundError, match="GFLOW_MAST3R_WEIGHTS"):
        prep_depth.main(a, device="cpu")


def test_mesh_devices_match_single(tmp_path):
    """mesh_devices=4 (4 CPU replicas; the logwin-2 graph's pairs in
    batches of 4, the tail batch padded and its padding dropped) against
    mesh_devices=0: depth within rtol 2e-3 / atol 2e-3
    (tests/test_sharded_infer.py:83), cameras within the module's
    tolerances."""
    _, _, model = tiny("linear")
    d0, d4 = write_frames(tmp_path / "single", n=5), write_frames(tmp_path / "mesh", n=5)
    prep_depth.main(d0, model=model, inference_size=48, winsize=2, mesh_devices=0,
                    device="cpu")
    prep_depth.main(d4, model=model, inference_size=48, winsize=2, mesh_devices=4,
                    device="cpu")
    deps = files(d0, DIRS[0])
    assert len(deps) == 10
    for a, b in zip(files(d4, DIRS[0]), deps):
        if a.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=2e-3, atol=2e-3)
    for a, b in zip(files(d4, DIRS[2]), files(d0, DIRS[2])):
        ga, gb = (json.load(open(p)) for p in (a, b))
        assert ga["focal"] == pytest.approx(gb["focal"], rel=1e-4)
        np.testing.assert_allclose(ga["pose"], gb["pose"], atol=1e-3)


def test_depth_goes_back_to_the_frame_size():
    """At 288 a 854x480 frame runs at 512x288; its depth resized by the
    short side comes back 853 wide (the JAX module's resize), the port's
    goes to exactly 480x854, and equals the short-side resize where that
    one lands on the frame's size."""
    from gflow_tpu.core.io import resize_image as jax_resize
    from gflow_tpu_torch.core.io import _resize_hw, resize_image, resize_to

    assert _resize_hw((480, 854), 288) == (288, 512)
    d = np.random.default_rng(0).uniform(1, 2, (288, 512)).astype(np.float32)
    assert jax_resize(d, 480).shape == (480, 853)
    assert resize_to(d, (480, 854)).shape == (480, 854)
    e = np.random.default_rng(1).uniform(1, 2, (512, 911)).astype(np.float32)
    np.testing.assert_array_equal(resize_to(e, (480, 854)), resize_image(e, 480))
    png = prep_depth.depth_png(d)
    assert png.shape == (288, 512, 3) and png.dtype == np.uint8
