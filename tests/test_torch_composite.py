"""Port parity: the compositor (gflow_tpu_torch.ops.composite, the plain
version of kernels K1/K2/K3) against the JAX package's Pallas compositor
run in Pallas interpret mode on the CPU, plus the dense oracle.

Both sides get the same tile lists (binned by the JAX package) and the same
per-Gaussian inputs. Tolerances: images atol 1e-4 (both are f32 sums of the
same terms in another order); coverage: exact support, as
tests/test_pallas.py:97; gradients for uv/conic/opacity/features
normalized by max |ref|, atol 5e-4 (tests/test_pallas.py:62-67)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core.camera import default_intrinsics
from gflow_tpu.ops import pallas_raster
from gflow_tpu.ops.binning import bin_gaussians, tile_grid
from gflow_tpu.ops.projection import project_gaussians
from gflow_tpu.ops.reference import composite_dense as j_dense
from gflow_tpu_torch.ops import composite, cuda_raster
from gflow_tpu_torch.ops.reference import composite_dense as t_dense

W, H = 64, 48


def setup(seed, n=384, K=64, bg=0.25):
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))].astype(np.float32)
    scale = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rotate = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    feats = np.c_[rng.uniform(0, 1, (n, 3)), xyz[:, 2:]].astype(np.float32)
    intr = default_intrinsics(W, H)
    extr = jnp.asarray(np.c_[np.eye(3), np.zeros(3)], jnp.float32)
    proj = project_gaussians(jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(rotate),
                             intr, extr, W, H)
    bins = bin_gaussians(proj["uv"], proj["depth"], proj["radius"], W, H, K, 32)
    arrays = dict(uv=np.array(proj["uv"]), conic=np.array(proj["conic"]), opacity=opacity,
                  features=feats, depth=np.array(proj["depth"]),
                  radius=np.array(proj["radius"]))
    return bins, arrays, bg


def tile_args(bins):
    lists, counts = np.array(bins.tile_lists), np.array(bins.tile_counts)
    return (jnp.asarray(lists), jnp.asarray(counts)), (torch.from_numpy(lists),
                                                        torch.from_numpy(counts))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("GFLOW_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("seed,K", [(0, 64), (1, 32)])
def test_forward_matches_pallas(interpret, seed, K):
    bins, a, bg = setup(seed, K=K)
    n_tx, n_ty = tile_grid(W, H)
    (jl, jc), (tl, tc) = tile_args(bins)
    if K == 32:
        assert (np.asarray(jc) > K).any()  # truncation to the nearest K bites
    keys = ("uv", "conic", "opacity", "features")
    img_j = pallas_raster.composite_tiles_pallas(
        jl, *(jnp.asarray(a[k]) for k in keys), bg, W, H, n_tx, n_ty, tile_counts=jc)
    img_t = cuda_raster.composite_tiles_kernel(
        tl, *(torch.from_numpy(a[k]) for k in keys), bg, W, H, n_tx, n_ty, tile_counts=tc)
    assert img_t.shape == (H, W, 4)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)


def test_gradients_match_pallas(interpret):
    bins, a, bg = setup(2)
    n_tx, n_ty = tile_grid(W, H)
    (jl, jc), (tl, tc) = tile_args(bins)
    G = np.random.default_rng(3).normal(size=(H, W, 4)).astype(np.float32)
    keys = ("uv", "conic", "opacity", "features")

    def loss_j(*xs):
        img = pallas_raster.composite_tiles_pallas(jl, *xs, bg, W, H, n_tx, n_ty,
                                                   tile_counts=jc)
        return jnp.sum(img * G)

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a[k]) for k in keys))
    xs = [torch.from_numpy(a[k]).requires_grad_() for k in keys]
    img = cuda_raster.composite_tiles_kernel(tl, *xs, bg, W, H, n_tx, n_ty, tile_counts=tc)
    gt = torch.autograd.grad((img * torch.from_numpy(G)).sum(), xs)
    for k, g_t, g_j in zip(keys, gt, gj):
        ref = np.abs(np.asarray(g_j)).max()
        assert ref > 0, k
        np.testing.assert_allclose(g_t.numpy() / ref, np.asarray(g_j) / ref, atol=5e-4,
                                   err_msg=k)


def test_coverage_matches_pallas(interpret):
    bins, a, bg = setup(4)
    n_tx, n_ty = tile_grid(W, H)
    (jl, jc), (tl, tc) = tile_args(bins)
    n = a["uv"].shape[0]
    mov = (np.random.default_rng(5).uniform(size=(n, 1)) < 0.4).astype(np.float32)
    keys = ("uv", "conic", "opacity", "features")
    img_j, cov_j = pallas_raster.composite_with_coverage_pallas(
        jl, *(jnp.asarray(a[k]) for k in keys), jnp.asarray(mov), bg, W, H, n_tx, n_ty,
        tile_counts=jc)
    img_t, cov_t = cuda_raster.composite_with_coverage_kernel(
        tl, *(torch.from_numpy(a[k]) for k in keys), torch.from_numpy(mov), bg, W, H,
        n_tx, n_ty, tile_counts=tc)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    cj = np.asarray(cov_j)
    assert 0 < (cj > 0).mean() < 1
    np.testing.assert_array_equal(cov_t.numpy() > 0, cj > 0)
    np.testing.assert_allclose(cov_t.numpy(), cj, atol=1e-5)
    assert not cov_t.requires_grad


def test_packed_plain_matches_pallas_packed_call(interpret):
    """The (T, K, CA) -> (T, 256, F) plain version against the Pallas
    packed call itself, with garbage in the slots past each tile's count
    (the kernels must ignore them)."""
    rng = np.random.default_rng(6)
    n_tx, T, K, F = 3, 8, 16, 2
    g = rng.normal(size=(T, K, 6 + F)).astype(np.float32)
    t = np.arange(T)
    g[..., 0] = (t % n_tx)[:, None] * 16 + rng.uniform(-4, 20, (T, K))
    g[..., 1] = (t // n_tx)[:, None] * 16 + rng.uniform(-4, 20, (T, K))
    g[..., 2] = rng.uniform(0.02, 0.5, (T, K))
    g[..., 3] = rng.uniform(-0.01, 0.01, (T, K))
    g[..., 4] = rng.uniform(0.02, 0.5, (T, K))
    g[..., 5] = rng.uniform(0.1, 0.99, (T, K))
    counts = np.array([0, 1, 5, 16, 9, 3, 16, 12], np.int32)
    bg = np.array([0.3, 0.6], np.float32)
    out_j = pallas_raster._packed_composite(jnp.asarray(g), jnp.asarray(counts),
                                            jnp.asarray(bg), n_tx)
    out_t = composite.composite_packed(torch.from_numpy(g), torch.from_numpy(counts),
                                       torch.from_numpy(bg), n_tx)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(out_t.numpy()[0], np.broadcast_to(bg, (256, F)))


@pytest.mark.parametrize("seed", [0, 7])
def test_dense_oracle_matches_jax(seed):
    bins, a, bg = setup(seed, n=96)
    args = [a[k] for k in ("uv", "conic", "opacity", "features", "depth", "radius")]
    out_j = j_dense(*(jnp.asarray(x) for x in args), bg, W, H)
    out_t = t_dense(*(torch.from_numpy(x) for x in args), bg, W, H)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)


def test_kernel_wrapper_takes_plain_path_only_for_cpu_tensors():
    """On a CPU tensor the wrapper composites through the plain version,
    bit for bit."""
    bins, a, bg = setup(8)
    n_tx, n_ty = tile_grid(W, H)
    _, (tl, tc) = tile_args(bins)
    xs = [torch.from_numpy(a[k]) for k in ("uv", "conic", "opacity", "features")]
    got = cuda_raster.composite_tiles_kernel(tl, *xs, bg, W, H, n_tx, n_ty, tile_counts=tc)
    g_attrs, counts = composite.pack_attrs(tl, tc, torch.cat(xs, dim=1))
    bg_t = composite.bg_vector(bg, 4, "cpu")
    want = composite.untile(composite.composite_packed(g_attrs, counts, bg_t, n_tx),
                            n_tx, n_ty, W, H)
    assert torch.equal(got, want)
    assert torch.equal(cuda_raster.packed_composite(g_attrs, counts, bg_t, n_tx),
                       composite.composite_packed(g_attrs, counts, bg_t, n_tx))
    with pytest.raises(ValueError):  # the kernel launchers refuse bad input
        cuda_raster.composite_fwd(torch.zeros(2, 4, 10, dtype=torch.float64),
                                  torch.zeros(2, dtype=torch.int32), torch.zeros(4), 1)
