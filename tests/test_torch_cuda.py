"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the card. CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU
and skip without one; on the GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: images atol 5e-4 / rtol 1e-3 (tests/test_pallas.py:42-44);
coverage support exact where the plain coverage is clear of 0 by 1e-3;
gradients normalized by max |ref| per column, atol 5e-4; K3 bitwise
repeatable (no float atomics); K4 (the binning tail) exact, on the
sorted-stream cases of tests/test_torch_tail_cases.py."""
import numpy as np
import pytest
import torch

from gflow_tpu_torch.ops import _build, binning, composite, cuda_raster
from test_torch_tail_cases import TAIL_CASES, tail_stream, tail_tensors

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def packed(dev, T=12, K=40, F=4, with_cov=False, n_tx=4, seed=0, first_counts=(0,)):
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
    counts[:len(first_counts) + 1] = torch.tensor([*first_counts, K], dtype=torch.int32)
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


def assert_tail_equal(args):
    got = binning.bin_tail(*args)
    want = binning.bin_tail_plain(*args)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32 and g_.is_cuda
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("case", TAIL_CASES)
def test_bin_tail_kernel_equals_plain(dev, case):
    assert_tail_equal(tail_tensors(tail_stream(case), dev))


@pytest.mark.parametrize("ids", ["group", "tensor"])
@pytest.mark.parametrize("K", [96, 192])
def test_pack_kernel_exact(dev, K, ids):
    """The canonical shapes: T = 1620 tiles of the 854x480 frame, L =
    409,600 entries (51,200 Gaussians x 8); also with the keys at an offset
    into their storage (an address that is not 16-byte aligned)."""
    T, L, G = 1620, 409_600, 8
    g = torch.Generator().manual_seed(K)
    nbits = 31 - (T + 1).bit_length()
    keys = (torch.randint(0, T + 1, (L,), generator=g) << nbits) | torch.randint(
        0, 2 ** nbits, (L,), generator=g)
    key_s, order = torch.sort(keys.to(torch.int32).to(dev))
    idx_flat = G if ids == "group" else torch.randint(0, L // G, (L,), generator=g,
                                                       dtype=torch.int32).to(dev)
    assert_tail_equal((key_s, order, idx_flat, nbits, T, K))
    shifted = torch.cat([key_s[:1], key_s])[1:]
    assert shifted.data_ptr() % 16
    assert_tail_equal((shifted, order, idx_flat, nbits, T, K))


@pytest.mark.parametrize("small", [0, 8])
def test_bin_gaussians_kernel_equals_plain(dev, monkeypatch, small):
    """bin_gaussians single-class (no id array) and two-class through the
    tail kernel against the same call through bin_tail_plain; one launch
    per call."""
    from gflow_tpu_torch.ops.projection import project_gaussians

    Wd, Hd, n = 160, 96, 700
    rng = np.random.default_rng(4)
    xyz = torch.tensor(np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))],
                       dtype=torch.float32, device=dev)
    scale = torch.tensor(rng.uniform(0.02, 0.15, (n, 3)), dtype=torch.float32, device=dev)
    rot = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32, device=dev)
    intr = torch.tensor([80.0, 80.0, Wd / 2, Hd / 2], device=dev)
    proj = project_gaussians(xyz, scale, rot, intr, torch.eye(3, 4, device=dev), Wd, Hd)
    kw = dict(max_per_tile=32, max_tiles_per_gaussian=48, small_tiles_per_gaussian=small)
    _build.LAUNCHES.clear()
    got = binning.bin_gaussians(proj["uv"], proj["depth"], proj["radius"], Wd, Hd, **kw)
    assert dict(_build.LAUNCHES) == {"bin_tail": 1}
    monkeypatch.setattr(binning, "bin_tail", binning.bin_tail_plain)
    want = binning.bin_gaussians(proj["uv"], proj["depth"], proj["radius"], Wd, Hd, **kw)
    assert torch.equal(got.tile_lists, want.tile_lists)
    assert torch.equal(got.tile_counts, want.tile_counts)
    assert (got.tile_counts > 32).any()  # some tiles overflow K


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
    assert _build.LAUNCHES["bin_tail"] == 1
    assert _build.LAUNCHES["composite_fwd"] == 1 and _build.LAUNCHES["composite_bwd"] == 1


def test_wrappers_refuse_bad_input(dev):
    attrs, counts, bg = packed(dev)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(attrs.double(), counts, bg, 4)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(attrs, counts.long(), bg, 4)
    key_s, order, idx_flat, nbits, T, K = tail_tensors(tail_stream("two_class"), dev)
    for bad in ((key_s.long(), order, idx_flat), (key_s, order.int(), idx_flat),
                (key_s, order, idx_flat.long()), (key_s, order, idx_flat.cpu()),
                (key_s, order, idx_flat[1:]), (key_s, order, 0), (key_s, order.cpu(), 4)):
        with pytest.raises(ValueError):
            binning.bin_tail(*bad, nbits, T, K)


def check_fwd_bwd(attrs, counts, bg, n_tx, with_cov, seed=0):
    """K1/K2 against the plain forward, K3 against autograd through it
    (twice, bitwise equal)."""
    got = cuda_raster.composite_fwd(attrs, counts, bg, n_tx, with_cov)
    want = composite.composite_packed(attrs, counts, bg, n_tx, with_cov)
    got, want = (got, want) if with_cov else ((got,), (want,))
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=5e-4, rtol=1e-3)
    if with_cov:
        clear = want[1].abs() > 1e-3
        assert torch.equal((got[1] > 0)[clear], (want[1] > 0)[clear])
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    g = torch.randn(want[0].shape, generator=gen, device=attrs.device)
    dk = cuda_raster.composite_bwd(attrs, counts, bg, g, n_tx, with_cov)
    a = attrs.clone().requires_grad_()
    out = composite.composite_packed(a, counts, bg, n_tx, with_cov)
    ref = torch.autograd.grad(out[0] if with_cov else out, a, g)[0]
    scale = ref.abs().amax(dim=(0, 1)).clamp_min(1e-12)
    err = float(((dk - ref) / scale).abs().max())
    assert err <= 5e-4, err
    if with_cov:
        assert not dk[..., -1].any()
    assert torch.equal(dk, cuda_raster.composite_bwd(attrs, counts, bg, g, n_tx, with_cov))
    return want


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("F", range(1, 9))
@pytest.mark.parametrize("K", [40, 96, 192, 256])
def test_kernels_at_edge_counts(dev, K, F, with_cov):
    """Tiles with 0, 1, R - 1 = 3 and one more than the K3 slot batch
    (32 // (6 + F)) live rows, and a full tile, beside random counts; CA =
    6 + F (K1) and 7 + F (K2, and K3 with the mov column)."""
    firsts = (0, 1, 3, 32 // (6 + F) + 1)
    attrs, counts, bg = packed(dev, K=K, F=F, with_cov=with_cov, seed=K + F,
                               first_counts=firsts)
    assert counts[:5].tolist() == [*firsts, K]
    check_fwd_bwd(attrs, counts, bg, 4, with_cov, seed=F)


@pytest.mark.parametrize("with_cov", [False, True])
def test_saturated_stack_underflows_transmittance(dev, with_cov):
    """48 wide splats at opacity 0.99 over one tile's centre: T underflows
    to exactly 0 there after ~23 of them; the forward still matches and
    K3's suffix (A - prefix) stays within the normalized tolerance."""
    K, F, T = 64, 4, 2
    rng = np.random.default_rng(7)
    uv = 8.0 + rng.uniform(-0.5, 0.5, (T, K, 2))
    conic = np.broadcast_to([0.08, 0.0, 0.08], (T, K, 3))
    op = np.full((T, K, 1), 0.99)
    cols = [uv, conic, op, rng.uniform(0, 1, (T, K, F))]
    if with_cov:
        cols.append((rng.uniform(size=(T, K, 1)) < 0.5).astype(np.float64))
    attrs = torch.tensor(np.concatenate(cols, -1), dtype=torch.float32, device=dev)
    counts = torch.tensor([48, K], dtype=torch.int32, device=dev)
    bg = torch.full((F,), 0.5, device=dev)
    px, py = composite.tile_pixels(T, 2, dev)
    alpha = composite.tile_alpha(attrs[..., 0:2], attrs[..., 2:5], attrs[..., 5:6], px, py)
    t_final = torch.prod(1.0 - alpha, dim=1)
    assert int((t_final == 0).sum()) > 0  # the case under test
    check_fwd_bwd(attrs.contiguous(), counts, bg, 2, with_cov)


def test_backward_takes_a_misaligned_gradient(dev):
    attrs, counts, bg = packed(dev)
    g = torch.randn(12 * 256 * 4 + 1, device=dev)[1:].view(12, 256, 4)
    assert g.data_ptr() % 16
    torch.testing.assert_close(cuda_raster.composite_bwd(attrs, counts, bg, g, 4),
                               cuda_raster.composite_bwd(attrs, counts, bg, g.clone(), 4),
                               rtol=0, atol=0)
