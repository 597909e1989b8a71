"""Port parity: the band wrappers (gflow_tpu_torch.ops.cuda_raster.*_sharded,
on 4 CPU bands, each band through the plain compositor) against the JAX
package's shard_map wrappers (pallas_raster.*_sharded) under
jax.set_mesh(fitting_mesh(4)) on the virtual CPU devices, the Pallas
kernels in interpret mode, as tests/test_multichip.py runs them; and
against the port's unbanded compositor.

Two sizes: 64x48 has n_ty = 3, so 4 bands pad to 4 tile rows and the last
band is empty; 64x64 has n_ty = 4, one row per band. Both sides get the
same tile lists (binned by the JAX package) and per-Gaussian inputs.
Tolerances: against JAX images atol 1e-4 and gradients normalized by max
|ref| atol 5e-4 (tests/test_torch_composite.py); coverage support exact,
values atol 1e-5 (the JAX wrapper shifts uv.y by the band's origin in
float32, the port composites each band at its tile-row offset). Against
the unbanded port, which does the same arithmetic per tile: images and
coverage atol 1e-6, gradients normalized atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core.camera import default_intrinsics
from gflow_tpu.ops import pallas_raster
from gflow_tpu.ops.binning import bin_gaussians, tile_grid
from gflow_tpu.ops.projection import project_gaussians
from gflow_tpu.parallel.mesh import fitting_mesh as jax_fitting_mesh
from gflow_tpu_torch.ops import _build, cuda_raster
from gflow_tpu_torch.parallel.mesh import fitting_mesh

KEYS = ("uv", "conic", "opacity", "features")
SIZES = [(64, 48), (64, 64)]
BANDS = fitting_mesh(4, "cpu").flat


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("GFLOW_PALLAS_INTERPRET", "1")


def setup(W, H, seed=0, n=384, K=64):
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))].astype(np.float32)
    scale = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rotate = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    feats = np.c_[rng.uniform(0, 1, (n, 3)), xyz[:, 2:]].astype(np.float32)
    mov = (rng.uniform(size=(n, 1)) < 0.4).astype(np.float32)
    extr = jnp.asarray(np.c_[np.eye(3), np.zeros(3)], jnp.float32)
    proj = project_gaussians(jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(rotate),
                             default_intrinsics(W, H), extr, W, H)
    bins = bin_gaussians(proj["uv"], proj["depth"], proj["radius"], W, H, K, 32)
    arrays = dict(uv=np.array(proj["uv"]), conic=np.array(proj["conic"]), opacity=opacity,
                  features=feats, mov=mov)
    lists, counts = np.array(bins.tile_lists), np.array(bins.tile_counts)
    return arrays, lists, counts


def jax_sharded(fn, *args, **kw):
    with jax.set_mesh(jax_fitting_mesh(4)):
        return fn(*args, shard_axes=("tile",), **kw)


@pytest.mark.parametrize("W,H", SIZES)
def test_forward_matches_jax_sharded(W, H):
    a, lists, counts = setup(W, H)
    n_tx, n_ty = tile_grid(W, H)
    img_j = jax_sharded(pallas_raster.composite_tiles_pallas_sharded, jnp.asarray(lists),
                        *(jnp.asarray(a[k]) for k in KEYS), 0.25, W, H, n_tx, n_ty,
                        tile_counts=jnp.asarray(counts))
    xs = [torch.from_numpy(a[k]) for k in KEYS]
    tl, tc = torch.from_numpy(lists), torch.from_numpy(counts)
    img_t = cuda_raster.composite_tiles_kernel_sharded(tl, *xs, 0.25, W, H, n_tx, n_ty, BANDS,
                                                       tile_counts=tc)
    assert img_t.shape == (H, W, 4)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    whole = cuda_raster.composite_tiles_kernel(tl, *xs, 0.25, W, H, n_tx, n_ty, tile_counts=tc)
    torch.testing.assert_close(img_t, whole, atol=1e-6, rtol=0)


@pytest.mark.parametrize("W,H", SIZES)
def test_gradients_match_jax_sharded(W, H):
    a, lists, counts = setup(W, H, seed=2)
    n_tx, n_ty = tile_grid(W, H)
    G = np.random.default_rng(3).normal(size=(H, W, 4)).astype(np.float32)

    def loss_j(*xs):
        img = pallas_raster.composite_tiles_pallas_sharded(
            jnp.asarray(lists), *xs, 0.25, W, H, n_tx, n_ty, shard_axes=("tile",),
            tile_counts=jnp.asarray(counts))
        return jnp.sum(img * G)

    with jax.set_mesh(jax_fitting_mesh(4)):
        gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a[k]) for k in KEYS))

    def grads(fn, *extra):
        xs = [torch.from_numpy(a[k]).requires_grad_() for k in KEYS]
        img = fn(torch.from_numpy(lists), *xs, 0.25, W, H, n_tx, n_ty, *extra,
                 tile_counts=torch.from_numpy(counts))
        return torch.autograd.grad((img * torch.from_numpy(G)).sum(), xs)

    banded = grads(cuda_raster.composite_tiles_kernel_sharded, BANDS)
    whole = grads(cuda_raster.composite_tiles_kernel)
    for k, g_t, g_w, g_j in zip(KEYS, banded, whole, gj):
        ref = np.abs(np.asarray(g_j)).max()
        assert ref > 0, k
        np.testing.assert_allclose(g_t.numpy() / ref, np.asarray(g_j) / ref, atol=5e-4,
                                   err_msg=k)
        np.testing.assert_allclose(g_t.numpy() / ref, g_w.numpy() / ref, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("W,H", SIZES)
def test_coverage_matches_jax_sharded(W, H):
    a, lists, counts = setup(W, H, seed=4)
    n_tx, n_ty = tile_grid(W, H)
    img_j, cov_j = jax_sharded(pallas_raster.composite_with_coverage_pallas_sharded,
                               jnp.asarray(lists), *(jnp.asarray(a[k]) for k in KEYS),
                               jnp.asarray(a["mov"]), 0.25, W, H, n_tx, n_ty,
                               tile_counts=jnp.asarray(counts))
    xs = [torch.from_numpy(a[k]) for k in (*KEYS, "mov")]
    tl, tc = torch.from_numpy(lists), torch.from_numpy(counts)
    img_t, cov_t = cuda_raster.composite_with_coverage_kernel_sharded(
        tl, *xs, 0.25, W, H, n_tx, n_ty, BANDS, tile_counts=tc)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    cj = np.asarray(cov_j)
    assert cov_t.shape == (H, W, 1) and 0 < (cj > 0).mean() < 1
    np.testing.assert_array_equal(cov_t.numpy() > 0, cj > 0)
    np.testing.assert_allclose(cov_t.numpy(), cj, atol=1e-5)
    img_w, cov_w = cuda_raster.composite_with_coverage_kernel(tl, *xs, 0.25, W, H, n_tx, n_ty,
                                                              tile_counts=tc)
    torch.testing.assert_close(img_t, img_w, atol=1e-6, rtol=0)
    torch.testing.assert_close(cov_t, cov_w, atol=1e-6, rtol=0)


def test_band_rows_pad_with_empty_tiles():
    """64x48 in 4 bands: 3 tile rows pad to 4 (one band of empty tiles)."""
    _, lists, counts = setup(64, 48)
    n_tx, n_ty = tile_grid(64, 48)
    tl, tc, rows_per = cuda_raster.band_rows(torch.from_numpy(lists), torch.from_numpy(counts),
                                             n_tx, n_ty, 4)
    assert rows_per == 1 and tl.shape == (4 * n_tx, lists.shape[1]) and tc.shape == (4 * n_tx,)
    assert bool((tl[n_ty * n_tx:] == -1).all()) and not tc[n_ty * n_tx:].any()
    assert torch.equal(tl[:n_ty * n_tx], torch.from_numpy(lists))


def test_launch_refuses_tensors_off_one_card():
    """_build.launch takes the device from its tensor arguments and raises,
    before it builds anything, when they span devices or lie off the card."""
    cpu, meta = torch.zeros(4), torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="one device"):
        _build.launch("composite_fwd", cpu, meta, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        _build.launch("composite_fwd", cpu, cpu, 3)
    assert not _build.LAUNCHES["composite_fwd"]
