"""Port parity: core camera + scene (gflow_tpu_torch.core vs gflow_tpu.core),
on the cases of test_camera.py and test_scene.py. Inputs are made with
numpy from a seed and fed to both packages.

Tolerances: camera math is a handful of f32 operations in the same order
in both packages, so results agree to 1e-6 (the roundtrip checks keep
test_camera.py's own tolerances)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core import camera as jcam
from gflow_tpu.core import scene as jscene
from gflow_tpu_torch.core import camera as tcam
from gflow_tpu_torch.core import scene as tscene

from test_camera import random_rotation

ATOL = 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("seed", range(8))
def test_quat_rotmat_roundtrip_matches_jax(seed):
    R = random_rotation(seed).astype(np.float32)
    q_t = tcam.rotmat_to_quat_xyzw(t(R))
    q_j = jcam.rotmat_to_quat_xyzw(jnp.asarray(R))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=ATOL)
    R2 = tcam.quat_xyzw_to_rotmat(q_t)
    np.testing.assert_allclose(R2.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jcam.quat_xyzw_to_rotmat(q_j)),
                               atol=ATOL)


def test_identity_quats_and_wxyz_batch():
    np.testing.assert_allclose(tcam.quat_xyzw_to_rotmat(t([0, 0, 0, 1])).numpy(),
                               np.eye(3), atol=1e-7)
    q = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(tcam.quat_wxyz_to_rotmat(t(q)).numpy(),
                               np.asarray(jcam.quat_wxyz_to_rotmat(jnp.asarray(q))),
                               atol=ATOL)


def test_pose_extr_roundtrip_matches_jax():
    R = random_rotation(3)
    extr = np.concatenate([R, np.array([[0.3], [-0.2], [1.5]])], 1).astype(np.float32)
    pose_t = tcam.extr_to_pose(t(extr))
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(jcam.extr_to_pose(jnp.asarray(extr))),
                               atol=ATOL)
    np.testing.assert_allclose(tcam.pose_to_extr(pose_t).numpy(), extr, atol=1e-5)


def test_pix2world_world2pix_match_jax():
    """pix2world keeps the fx-for-both-axes quirk: fx != fy here, so a port
    that used fy for v would differ from the reference."""
    W, H = 64, 48
    intr = np.asarray([40.0, 52.0, W / 2, H / 2], np.float32)
    R = random_rotation(7)
    extr = np.concatenate([R, np.array([[0.1], [0.2], [0.3]])], 1).astype(np.float32)
    rng = np.random.default_rng(0)
    uv = rng.uniform(0, [W, H], size=(100, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, size=(100, 1)).astype(np.float32)
    xyz_t = tcam.pix2world(t(uv), t(depth), t(intr), t(extr))
    xyz_j = jcam.pix2world(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(intr),
                           jnp.asarray(extr))
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), atol=1e-5)
    xyz = np.array(xyz_j)
    xyz[:5, 2] -= 50.0  # some points behind the camera
    uv_t, d_t = tcam.world2pix(t(xyz), t(intr), t(extr))
    uv_j, d_j = jcam.world2pix(jnp.asarray(xyz), jnp.asarray(intr), jnp.asarray(extr))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-3, rtol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)


def test_default_intrinsics_and_pose_gradients():
    np.testing.assert_allclose(tcam.default_intrinsics(32, 24, device="cpu").numpy(),
                               np.asarray(jcam.default_intrinsics(32, 24)))
    xyz = np.asarray([[0.0, 0.0, 2.0], [0.5, -0.3, 3.0]], np.float32)
    intr = jcam.default_intrinsics(32, 32)
    pose0 = np.asarray([0.1, -0.05, 0.02, 1.0, 0.1, 0.0, 0.2], np.float32)

    def loss_j(pose):
        uv, depth = jcam.world2pix(jnp.asarray(xyz), intr, jcam.pose_to_extr(pose))
        return jnp.sum(uv**2) + jnp.sum(depth**2)

    pose = t(pose0).requires_grad_()
    uv, depth = tcam.world2pix(t(xyz), t(intr), tcam.pose_to_extr(pose))
    (uv.pow(2).sum() + depth.pow(2).sum()).backward()
    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(pose0)))
    np.testing.assert_allclose(pose.grad.numpy(), g_j, rtol=1e-4, atol=1e-3)
    assert np.abs(g_j).max() > 0


@pytest.mark.parametrize("name", ["scale", "rotate", "opacity", "rgb", "xyz"])
def test_activations_match_jax(name):
    x = np.random.default_rng(2).normal(size=(64, 4 if name == "rotate" else 3)).astype(np.float32)
    np.testing.assert_allclose(tscene.activate(name, t(x)).numpy(),
                               np.asarray(jscene.activate(name, jnp.asarray(x))), atol=ATOL)
    y = np.asarray(jscene.activate(name, jnp.asarray(x)))
    np.testing.assert_allclose(tscene.activate_inv(name, t(y)).numpy(),
                               np.asarray(jscene.activate_inv(name, jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)


def test_scene_constants():
    assert tscene.OPACITY_SENSITIVITY == jscene.OPACITY_SENSITIVITY
    for n in (1, 1000, 50_000, 123_457):
        assert tscene.scene_capacity(n) == jscene.scene_capacity(n)
