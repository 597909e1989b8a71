"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the card. CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU
and skip without one; on the GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: images atol 5e-4 / rtol 1e-3 (tests/test_pallas.py:42-44);
gradients normalized by max |ref| per column, atol 5e-4; K4 exact."""
import numpy as np
import pytest
import torch

from gflow_tpu_torch.ops import _build, binning, composite, cuda_raster

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def packed(dev, T=12, K=40, F=4, with_cov=False, n_tx=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    t = torch.arange(T)
    origin = torch.stack([(t % n_tx) * 16.0, (t // n_tx) * 16.0], -1)
    uv = origin[:, None] + u(T, K, 2) * 24 - 4
    a, c = 0.05 + 0.5 * u(T, K, 1), 0.05 + 0.5 * u(T, K, 1)
    b = (u(T, K, 1) - 0.5) * 0.8 * torch.sqrt(a * c)
    cols = [uv, a, b, c, 0.05 + 0.94 * u(T, K, 1), u(T, K, F)]
    if with_cov:
        cols.append((u(T, K, 1) < 0.5).float())
    attrs = torch.cat(cols, -1)
    counts = torch.randint(0, K + 1, (T,), generator=g).to(torch.int32)
    counts[0], counts[1] = 0, K
    bg = u(F)
    return attrs.to(dev), counts.to(dev), bg.to(dev)


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("K,F", [(40, 4), (64, 1), (200, 8)])
def test_forward_kernels_match_plain(dev, with_cov, K, F):
    attrs, counts, bg = packed(dev, K=K, F=F, with_cov=with_cov)
    got = cuda_raster.composite_fwd(attrs, counts, bg, 4, with_cov)
    want = composite.composite_packed(attrs, counts, bg, 4, with_cov)
    torch.cuda.synchronize()
    if with_cov:
        torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(got[1], want[1], atol=5e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("K", [40, 256])
def test_backward_kernel_matches_autograd(dev, with_cov, K):
    attrs, counts, bg = packed(dev, K=K, with_cov=with_cov, seed=1)
    g = torch.randn(attrs.shape[0], 256, 4, device=dev)
    got = cuda_raster.composite_bwd(attrs, counts, bg, g, 4, with_cov)
    a = attrs.clone().requires_grad_()
    out = composite.composite_packed(a, counts, bg, 4, with_cov)
    out = out[0] if with_cov else out
    want = torch.autograd.grad(out, a, g)[0]
    scale = want.abs().amax(dim=(0, 1)).clamp_min(1e-12)
    assert float(((got - want) / scale).abs().max()) <= 5e-4
    if with_cov:
        assert not got[..., -1].any()  # mov column: no gradient
    # deterministic: no float atomics
    assert torch.equal(got, cuda_raster.composite_bwd(attrs, counts, bg, g, 4, with_cov))


def test_pack_kernel_exact(dev):
    T, K, L = 30, 16, 500
    tiles = torch.sort(torch.randint(0, T + 1, (L,), dtype=torch.int32)).values.to(dev)
    idx = torch.randperm(L).to(torch.int32).to(dev)
    starts = torch.searchsorted(tiles, torch.arange(T + 1, dtype=torch.int32, device=dev),
                                out_int32=True)
    counts = (starts[1:] - starts[:T]).contiguous()
    got = binning.pack_tile_lists(idx, starts[:T].contiguous(), counts, K)
    assert torch.equal(got, binning.pack_tile_lists_plain(idx, starts[:T], counts, K))


def test_tile_compositor_gradients_and_launch_counts(dev, monkeypatch):
    """composite_tiles_kernel (gather -> K1/K3 -> scatter) against the same
    wrapper on the plain packed compositor's autograd, end to end on
    per-Gaussian inputs."""
    from gflow_tpu_torch.ops.projection import project_gaussians
    from gflow_tpu_torch.ops.binning import bin_gaussians, tile_grid

    Wd, Hd, n = 80, 48, 300
    rng = np.random.default_rng(2)
    xyz = torch.tensor(np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))],
                       dtype=torch.float32, device=dev)
    scale = torch.tensor(rng.uniform(0.02, 0.1, (n, 3)), dtype=torch.float32, device=dev)
    rot = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32, device=dev)
    intr = torch.tensor([40.0, 40.0, Wd / 2, Hd / 2], device=dev)
    extr = torch.eye(3, 4, device=dev)
    proj = project_gaussians(xyz, scale, rot, intr, extr, Wd, Hd)
    _build.LAUNCHES.clear()
    bins = bin_gaussians(proj["uv"], proj["depth"], proj["radius"], Wd, Hd, 64, 16)
    n_tx, n_ty = tile_grid(Wd, Hd)
    base = [proj["uv"], proj["conic"],
            torch.tensor(rng.uniform(0.2, 0.9, (n, 1)), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32, device=dev)]
    G = torch.randn(Hd, Wd, 3, device=dev)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(cuda_raster, "packed_composite", composite.composite_packed)
        xs = [x.detach().clone().requires_grad_() for x in base]
        img = cuda_raster.composite_tiles_kernel(bins.tile_lists, *xs, 0.3, Wd, Hd, n_tx,
                                                 n_ty, tile_counts=bins.tile_counts)
        grads.append((img, torch.autograd.grad((img * G).sum(), xs)))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=5e-4, rtol=1e-3)
    for gk, gp in zip(grads[0][1], grads[1][1]):
        ref = gp.abs().max()
        assert float(((gk - gp) / ref).abs().max()) <= 5e-4
    assert _build.LAUNCHES["pack_tile_lists"] == 1
    assert _build.LAUNCHES["composite_fwd"] == 1 and _build.LAUNCHES["composite_bwd"] == 1


def test_wrappers_refuse_bad_input(dev):
    attrs, counts, bg = packed(dev)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(attrs.double(), counts, bg, 4)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(attrs, counts.long(), bg, 4)
    with pytest.raises(ValueError):
        binning.pack_tile_lists(counts.long(), counts, counts, 8)
