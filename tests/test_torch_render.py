"""Port parity: multi-output render (gflow_tpu_torch.ops.render vs
gflow_tpu.ops.render.render), on the CPU: background fill, the center
view's opacity mask, every output at once, an odd frame size, the
scene-adaptive RenderConfig, render_traj (with capacity padding and
n_actual) and render_scene through GaussianScene and Camera.

Tolerances: images atol 1e-4 (same sums in another order); the turbo
depth colormap is a 256-bin lookup, so a depth at a bin edge may land one
bin over: depth_map_color is checked to 2e-2 on all but 0.5% of pixels;
uint8 outputs within one level."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core import camera as jcam
from gflow_tpu.ops.render import RenderConfig as JConfig
from gflow_tpu.ops.render import render as j_render
from gflow_tpu.viz.colormap import apply_float_colormap as j_cmap
from gflow_tpu_torch.ops.render import RenderConfig as TConfig
from gflow_tpu_torch.ops.render import render as t_render
from gflow_tpu_torch.ops.render import render2img
from gflow_tpu_torch.viz.colormap import apply_float_colormap as t_cmap

OUTPUTS = ("rgb", "uv", "depth", "depth_map", "depth_map_color", "acc", "center")


def scene(n=200, seed=0, W=64, H=48, n_dead=0):
    rng = np.random.default_rng(seed)
    z = 2.0 + 4.0 * (rng.permutation(n) + rng.uniform(0.1, 0.9, n)) / n
    xyz = np.c_[rng.uniform(-1, 1, (n, 2)) * z[:, None] / 2.5, z]
    scale = rng.uniform(0.02, 0.12, (n, 3))
    rotate = rng.normal(size=(n, 4))
    rotate /= np.linalg.norm(rotate, axis=1, keepdims=True)
    opacity = rng.uniform(0.3, 0.95, (n, 1))
    opacity[n - n_dead:] = 0.0  # dead / masked slots
    rgb = rng.uniform(0.05, 0.95, (n, 3))
    intr = np.array(jcam.default_intrinsics(W, H))
    extr = np.c_[np.eye(3), [0.02, -0.01, 0.0]]
    return [np.asarray(a, np.float32) for a in (xyz, scale, rotate, opacity, rgb, intr, extr)]


def both(arrays, bg, W, H, outputs=OUTPUTS, as_uint8=False, **cfg):
    oj = j_render(*(jnp.asarray(a) for a in arrays), bg, W, H, outputs=outputs,
                  config=JConfig(**cfg), as_uint8=as_uint8)
    ot = t_render(*(torch.from_numpy(a) for a in arrays), bg, W, H, outputs=outputs,
                  config=TConfig(**cfg), as_uint8=as_uint8, device="cpu")
    return {k: np.asarray(v) for k, v in oj.items()}, {k: v.numpy() for k, v in ot.items()}


def assert_colormap_close(t, j):
    bad = np.abs(t - j).max(axis=-1) > 2e-2
    assert bad.mean() <= 5e-3, bad.mean()


@pytest.mark.parametrize("W,H,bg", [(64, 48, 0.0), (97, 65, 1.0)])
def test_multi_output_render_matches_jax(W, H, bg):
    arrays = scene(n=240, seed=1, W=W, H=H, n_dead=30)
    oj, ot = both(arrays, bg, W, H, max_per_tile=64, max_tiles_per_gaussian=16)
    assert set(ot) == set(OUTPUTS)
    for k in OUTPUTS:
        assert ot[k].shape == oj[k].shape, k
        if k == "depth_map_color":
            assert_colormap_close(ot[k], oj[k])
        else:
            np.testing.assert_allclose(ot[k], oj[k], atol=1e-4, rtol=1e-5, err_msg=k)


def test_background_fill_and_center_mask():
    """All splats behind the camera: every pixel is background. Then the
    center view: opacity-0 (masked) points stay invisible."""
    W, H = 48, 32
    arrays = scene(n=50, seed=2, W=W, H=H)
    arrays[0] = arrays[0] * np.asarray([1, 1, -1], np.float32)
    _, ot = both(arrays, 0.7, W, H, outputs=("rgb", "center"))
    np.testing.assert_allclose(ot["rgb"], 0.7, atol=1e-6)
    np.testing.assert_allclose(ot["center"], 0.7, atol=1e-6)

    arrays = scene(n=50, seed=3, W=W, H=H)
    arrays[3][:] = 0.0
    oj, ot = both(arrays, 0.0, W, H, outputs=("center",))
    np.testing.assert_allclose(ot["center"], 0.0, atol=1e-7)
    np.testing.assert_allclose(ot["center"], oj["center"], atol=1e-7)


def test_uint8_outputs_and_render2img():
    W, H = 64, 48
    arrays = scene(n=150, seed=4)
    oj, ot = both(arrays, 0.0, W, H, outputs=("rgb", "acc", "center"), as_uint8=True)
    for k in ("rgb", "acc", "center"):
        assert ot[k].dtype == np.uint8
        assert np.abs(ot[k].astype(int) - oj[k].astype(int)).max() <= 1, k
    img = t_render(*(torch.from_numpy(a) for a in arrays), 0.0, W, H, outputs=("rgb",),
                   device="cpu")["rgb"]
    np.testing.assert_array_equal(render2img(img), (img.clamp(0, 1) * 255).to(torch.uint8).numpy())


@pytest.mark.parametrize("outputs", [("acc",), ("uv", "acc"), ("rgb", "acc"),
                                     ("depth_map", "acc")])
def test_acc_only_beside_a_main_output_as_in_jax(outputs):
    """acc rides along with the rgb/depth outputs: asked for alone (or
    beside uv) it is not rendered, as in the reference."""
    W, H = 64, 48
    arrays = scene(n=150, seed=6)
    oj, ot = both(arrays, 0.0, W, H, outputs=outputs)
    assert set(ot) == set(oj)
    assert ("acc" in ot) == any(k in outputs for k in ("rgb", "depth_map"))
    for k in ot:
        np.testing.assert_allclose(ot[k], oj[k], atol=1e-4, rtol=1e-5, err_msg=k)


def test_colormap_matches_jax():
    rng = np.random.default_rng(5)
    d = rng.uniform(1.0, 5.0, (20, 30, 1)).astype(np.float32)
    d[:3] = 0.0
    for non_zero in (False, True):
        for cmap in ("turbo", "grey"):
            np.testing.assert_allclose(
                t_cmap(torch.from_numpy(d), cmap, non_zero).numpy(),
                np.asarray(j_cmap(jnp.asarray(d), cmap, non_zero)), atol=1e-6)


@pytest.mark.parametrize("W,H,n,textured", [(854, 480, 50_000, True),
                                            (854, 480, 10_000, False),
                                            (320, 240, 400, False)])
def test_for_scene_matches_jax(W, H, n, textured):
    img = None
    if textured:
        img = np.random.default_rng(6).uniform(0, 1, (H, W, 3)).astype(np.float32)
    tc, jc = TConfig.for_scene(W, H, n, image=img), JConfig.for_scene(W, H, n, image=img)
    for f in ("max_per_tile", "max_tiles_per_gaussian", "small_tiles_per_gaussian",
              "large_frac"):
        assert getattr(tc, f) == getattr(jc, f), f


def traj_line_set(n_actual, cap, seed=7, W=64, H=48):
    """A trajectory line set as the trainer pads it: n_actual points at
    opacity 0.99 * alpha^k, then padding behind the camera at opacity 0."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:, 2] = -1.0
    z = rng.uniform(2.0, 4.0, n_actual)
    xyz[:n_actual] = np.c_[rng.uniform(-0.6, 0.6, (n_actual, 2)) * z[:, None], z]
    op = np.zeros((cap, 1), np.float32)
    op[:n_actual] = 0.99 * 0.8 ** rng.integers(0, 4, (n_actual, 1))
    rgb = np.zeros((cap, 3), np.float32)
    rgb[:n_actual] = rng.uniform(0.05, 0.95, (n_actual, 3))
    scale = np.full((cap, 3), 1e-6, np.float32)
    rot = np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (cap, 1))
    intr = np.array(jcam.default_intrinsics(W, H))
    extr = np.c_[np.eye(3), [0.02, -0.01, 0.0]].astype(np.float32)
    return xyz, scale, rot, op, rgb, intr, extr


@pytest.mark.parametrize("n_actual,cap,point_num", [(300, 512, 16), (512, 512, 40),
                                                    (90, 256, 90)])
def test_render_traj_matches_jax(n_actual, cap, point_num):
    from gflow_tpu.ops.render import render_traj as j_traj
    from gflow_tpu_torch.ops.render import render_traj as t_traj

    W, H = 64, 48
    arrays = traj_line_set(n_actual, cap, W=W, H=H)
    cfg = dict(max_per_tile=128, max_tiles_per_gaussian=8)
    want = np.asarray(j_traj(*(jnp.asarray(a) for a in arrays), 0.0, W, H, point_num,
                             0.5, 2.0, JConfig(**cfg), jnp.asarray(n_actual, jnp.int32)))
    got = t_traj(*(torch.from_numpy(a) for a in arrays), 0.0, W, H, point_num, 0.5, 2.0,
                 TConfig(**cfg), n_actual=n_actual, device="cpu").numpy()
    assert got.shape == want.shape == (H, W, 3)
    assert got.max() > 0.1  # the line set is visible
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_render_scene_matches_jax():
    """A saved scene's raw attributes (as a checkpoint holds them) and a
    camera from an extrinsic matrix, rendered by both packages."""
    from gflow_tpu.core.scene import scene_from_arrays as j_scene
    from gflow_tpu.ops.render import render_scene as j_render_scene
    from gflow_tpu_torch.core.camera import Camera
    from gflow_tpu_torch.core.scene import GaussianScene
    from gflow_tpu_torch.ops.render import render_scene as t_render_scene

    W, H = 64, 48
    xyz, scale, rotate, opacity, rgb, _, extr = scene(n=180, seed=9, W=W, H=H)
    js = j_scene(256, *(jnp.asarray(a) for a in (xyz, scale, rotate, opacity[:, 0], rgb)))
    ts = GaussianScene(*(torch.from_numpy(np.array(getattr(js, f))) for f in
                         ("xyz", "scale", "rotate", "opacity", "rgb")), n_alive=180)
    intr = np.array([50.0, 50.0, 30.5, 25.0], np.float32)
    jcamera = jcam.Camera(jnp.asarray(intr), jnp.zeros(7)).with_extr(extr)
    tcamera = Camera(torch.from_numpy(intr), torch.zeros(7)).with_extr(extr)
    np.testing.assert_allclose(tcamera.extr.numpy(), np.asarray(jcamera.extr), atol=1e-6)
    outs = ("rgb", "depth_map", "center")
    cfg = dict(max_per_tile=64, max_tiles_per_gaussian=16)
    oj = j_render_scene(js, jcamera, 0.2, W, H, outs, JConfig(**cfg))
    ot = t_render_scene(ts, tcamera, 0.2, W, H, outs, TConfig(**cfg), device="cpu")
    for k in outs:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4, rtol=1e-5,
                                   err_msg=k)


def _call_entry_point(name):
    from gflow_tpu_torch import convert
    from gflow_tpu_torch.opt import train
    from gflow_tpu_torch.core.camera import default_intrinsics
    from gflow_tpu_torch.opt.initialize import init_params_from_image
    from gflow_tpu_torch.opt.state import init_frame_state

    arrays = scene(n=10)
    if name == "render":
        t_render(*(torch.from_numpy(a) for a in arrays), 0.0, 64, 48, outputs=("rgb",))
    elif name == "init_params_from_image":
        img = np.full((48, 64, 3), 0.5, np.float32)
        init_params_from_image(img, np.full((48, 64), 2.0, np.float32), 10, 16,
                               arrays[5], arrays[6], rng=np.random.default_rng(0))
    elif name == "params_from_numpy":
        keys = ("xyz", "scale", "rotate", "opacity", "rgb")
        convert.params_from_numpy({**dict(zip(keys, arrays[:5])),
                                   "pose": np.zeros(7, np.float32),
                                   "depth_ab": np.zeros(2, np.float32)})
    elif name == "init_frame_state":
        init_frame_state(16)
    elif name == "default_intrinsics":
        default_intrinsics(64, 48)
    elif name == "render_traj":
        from gflow_tpu_torch.ops.render import render_traj

        render_traj(*traj_line_set(8, 8), 0.0, 64, 48, 2)
    elif name == "GFlowTrainer":
        from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

        GFlowTrainer(np.zeros((48, 64, 3), np.float32), make_logs=False)
    else:  # the device is resolved before any argument is read
        train.train_stage(None, None, None, arrays[5], torch.Generator(),
                          train.StageConfig(W=64, H=48, iterations=1), train.StageDynamics())


@pytest.mark.parametrize("entry", ["render", "init_params_from_image", "params_from_numpy",
                                   "train_stage", "init_frame_state", "default_intrinsics",
                                   "render_traj", "GFlowTrainer"])
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, entry):
    """Entry points run on cuda by default and raise without a GPU rather
    than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_entry_point(entry)
