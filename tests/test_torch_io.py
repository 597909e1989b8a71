"""Port parity: file IO (gflow_tpu_torch.core.io vs gflow_tpu.core.io), on
the CPU.

Tolerances: readers, writers and list_sequence_files exact; resize_image
to 1e-5 on [0, 1] data (torch's antialiased bilinear against
jax.image.resize's linear antialias: the same triangle filter, summed in
another order). The port reads and writes images with PIL alone; its
imread and imwrite are held exact against imageio's, PNG and JPEG,
palette images included."""
import json

import imageio.v2 as imageio
import numpy as np
import pytest

from gflow_tpu.core import io as jio
from gflow_tpu_torch.core import io as tio
from tests.synth import make_sequence


def smooth_image(shape, seed=0):
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    C = shape[2] if len(shape) == 3 else 1
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([xx, yy, xx * yy, 1 - xx], -1)[..., :C]
    img = (base * 255 + rng.normal(0, 3, (H, W, C))).clip(0, 255).astype(np.uint8)
    return img.reshape(shape)


def palette_png(path, index):
    """A palette PNG (as DAVIS masks are): index 0 black, 1 also black, 2
    red, 3 green."""
    from PIL import Image

    img = Image.fromarray(index.astype(np.uint8), mode="P")
    img.putpalette([0, 0, 0, 0, 0, 0, 255, 0, 0, 0, 255, 0] + [0] * (3 * 252))
    img.save(path)


@pytest.mark.parametrize("shape,suffix", [
    *[(s, ".png") for s in ((64, 96), (64, 96, 2), (64, 96, 3), (64, 96, 4), (5, 7, 3))],
    *[(s, ".jpg") for s in ((64, 96), (64, 96, 3), (5, 7, 3))]])  # JPEG: no alpha
def test_imread_imwrite_match_imageio(tmp_path, shape, suffix):
    """PIL alone reads and writes what imageio does: a file either one
    wrote reads back the same through both."""
    img = smooth_image(shape)
    imageio.imwrite(tmp_path / f"lib{suffix}", img)
    tio.imwrite(tmp_path / f"port{suffix}", img)
    for name in ("lib", "port"):
        got = tio.imread(tmp_path / f"{name}{suffix}")
        want = imageio.imread(tmp_path / f"{name}{suffix}")
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    if suffix == ".png":
        np.testing.assert_array_equal(tio.imread(tmp_path / "port.png"), img)
    else:  # the same encoder at the same default quality
        assert (tmp_path / "lib.jpg").read_bytes() == (tmp_path / "port.jpg").read_bytes()


def test_imread_expands_palette_as_imageio(tmp_path):
    index = np.zeros((16, 24), np.uint8)
    index[2:8, 3:9], index[9:14, 10:20], index[1:4, 15:22] = 1, 2, 3
    palette_png(tmp_path / "p.png", index)
    got = tio.imread(tmp_path / "p.png")
    assert got.shape == (16, 24, 3)
    np.testing.assert_array_equal(got, imageio.imread(tmp_path / "p.png"))
    # index 1 is black: the mask is where the color is, as in the JAX package
    np.testing.assert_array_equal(tio.read_mask(tmp_path / "p.png"),
                                  jio.read_mask(tmp_path / "p.png"))
    assert tio.read_mask(tmp_path / "p.png").sum() == (index >= 2).sum()


def test_flo_both_ways(tmp_path):
    flow = np.random.default_rng(0).normal(0, 3, (24, 32, 2)).astype(np.float32)
    jio.write_flow(tmp_path / "j.flo", flow)
    tio.write_flow(tmp_path / "t.flo", flow)
    assert (tmp_path / "j.flo").read_bytes() == (tmp_path / "t.flo").read_bytes()
    np.testing.assert_array_equal(tio.read_flow(tmp_path / "j.flo"), flow)
    np.testing.assert_allclose(tio.read_flow(tmp_path / "j.flo", resize=12),
                               jio.read_flow(tmp_path / "j.flo", resize=12), atol=1e-5)
    (tmp_path / "bad.flo").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        tio.read_flow(tmp_path / "bad.flo")


@pytest.mark.parametrize("hw,size", [((64, 96), 32), ((64, 96), 40), ((48, 64), 96),
                                     ((50, 70), 33), ((30, 40), 45), ((100, 100), 37),
                                     ((64, 96), 64), ((70, 50), 20)])
@pytest.mark.parametrize("channels", [None, 2, 3])
def test_resize_matches_jax(hw, size, channels):
    shape = hw if channels is None else (*hw, channels)
    arr = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    got, want = tio.resize_image(arr, size), jio.resize_image(arr, size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tio.resize_image(arr, None) is arr


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
def test_readers_match_jax(tmp_path, suffix):
    rgb = smooth_image((64, 96, 3), 2)
    imageio.imwrite(tmp_path / f"f{suffix}", rgb)
    rgba = smooth_image((64, 96, 4), 3)
    imageio.imwrite(tmp_path / "a.png", rgba)
    grey = smooth_image((64, 96), 4)
    imageio.imwrite(tmp_path / "g.png", grey)
    m = np.zeros((64, 96), np.uint8)
    m[10:30, 20:50] = 255
    imageio.imwrite(tmp_path / "m.png", m)
    imageio.imwrite(tmp_path / "m3.png", np.repeat(m[..., None], 3, -1))
    for name in (f"f{suffix}", "a.png", "g.png"):
        np.testing.assert_array_equal(tio.load_image(tmp_path / name),
                                      jio.load_image(tmp_path / name))
        np.testing.assert_allclose(tio.load_image(tmp_path / name, resize=32, blur=True),
                                   jio.load_image(tmp_path / name, resize=32, blur=True),
                                   atol=1e-5)
    for name in ("m.png", "m3.png"):
        np.testing.assert_array_equal(tio.read_mask(tmp_path / name),
                                      jio.read_mask(tmp_path / name))
        np.testing.assert_array_equal(tio.read_mask(tmp_path / name, resize=40),
                                      jio.read_mask(tmp_path / name, resize=40))
    d = np.random.default_rng(5).uniform(1, 3, (64, 96)).astype(np.float32)
    np.save(tmp_path / "d.npy", d)
    np.testing.assert_array_equal(tio.read_depth(tmp_path / "d.npy", None, 2.0, 0.5),
                                  jio.read_depth(tmp_path / "d.npy", None, 2.0, 0.5))
    np.testing.assert_allclose(tio.read_depth(tmp_path / "d.npy", 32),
                               jio.read_depth(tmp_path / "d.npy", 32), atol=1e-5, rtol=1e-6)


def test_camera_json_both_ways(tmp_path):
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(np.random.default_rng(8).normal(size=(3, 3)))[0]
    pose[:3, 3] = [1, 2, 3]
    jio.write_camera(tmp_path / "0.json", 321.5, pose, (30.4, 20.6))
    tio.write_camera(tmp_path / "1.json", 321.5, pose, (30.4, 20.6))
    assert json.load(open(tmp_path / "0.json")) == json.load(open(tmp_path / "1.json"))
    paths = [tmp_path / "0.json", tmp_path / "1.json"]
    (fj, ppj, pj), (ft, ppt, pt) = jio.read_camera(paths), tio.read_camera(paths)
    assert fj == ft and ppj == ppt == [30, 21]
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("kw", [{}, {"frame_start": 1, "frame_range": 2},
                                {"skip_interval": 2}])
def test_list_sequence_files_matches_jax(tmp_path, kw):
    seq = make_sequence(tmp_path, n_frames=5, W=48, H=32)
    got, want = tio.list_sequence_files(seq, **kw), jio.list_sequence_files(seq, **kw)
    assert got == want
    assert len(got["images"]) and len(got["flows"]) and len(got["cameras"])
