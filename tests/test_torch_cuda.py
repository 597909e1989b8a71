"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the card. CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU
and skip without one; on the GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: images atol 5e-4 / rtol 1e-3 (tests/test_pallas.py:42-44);
coverage support exact where the plain coverage is clear of 0 by 1e-3;
gradients normalized by max |ref| per column, atol 5e-4; K3 bitwise
repeatable (no float atomics); K4 (the binning tail) exact, on the
sorted-stream cases of tests/test_torch_tail_cases.py. The stage, banded
or not, the host-called renders and projections, and the prior
preparation's compiled paths (the alignment's Adam steps, the GMFlow and
MASt3R forwards, the LMedS, the B-frame step) run as CUDA graphs equal the
same calls eager exactly, deterministic algorithms on; a banded stage
equals the unbanded one to 1e-6; a stage that stamps its iterations'
pieces (ops/stamp.py) equals the same stage unstamped exactly. small_eig (the LMedS's eigensolver)
against torch.linalg.eigh on separated spectra, n = 1..9 and batches of
1, 33 and 512: residual |A v - l v| / |A| <= 1e-5 and |v . v_eigh| >=
1 - 1e-5; a twice-repeated smallest eigenvalue: the residual, and v in
its eigenspace to 1 - 1e-5; the zero matrix and the identity: a finite
unit vector; a matrix of NaNs leaves the rest of its batch exactly as
without it. The SSIM kernels (ops/ssim.py) against the plain version at
854x480x3 and at sizes down to 7x5 (smaller than the window), one and
three channels: the mean within 1e-6 absolute, bitwise repeatable;
dL/dimg1 within 1e-5 of its largest entry (assert_ssim_grads_close); the
camera-only masked input and a channel slice read in place; under no_grad
no coefficient maps; a captured call replays exactly as the eager one; in
a stamped stage ssim_bwd once an iteration. SAM's mask decoder's
image-stream kernels (ops/sam_decoder.py) against their plain versions at
the automatic grid's shapes and at ragged key counts and 1 to 8 tokens
(stream_init bitwise, the rest within 1e-5 of the largest value); a
64-prompt decode graphed equals it eager, with 1 + 3 + 2 + 2 launches,
and the CPU's to 1e-4."""
import contextlib

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


def _traj_scene(dev, n_actual=300, cap=512, W=96, H=64, seed=3):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:, 2] = -1.0
    z = rng.uniform(2.0, 4.0, n_actual)
    xyz[:n_actual] = np.c_[rng.uniform(-0.6, 0.6, (n_actual, 2)) * z[:, None], z]
    op = np.zeros((cap, 1), np.float32)
    op[:n_actual] = 0.99 * 0.8 ** rng.integers(0, 4, (n_actual, 1))
    rgb = rng.uniform(0.05, 0.95, (cap, 3)).astype(np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (t(xyz), t(np.full((cap, 3), 1e-6)), t(np.tile([1.0, 0, 0, 0], (cap, 1))), t(op),
            t(rgb), t([W / 2.0, W / 2.0, W / 2, H / 2]), torch.eye(3, 4, device=dev))


def test_render_traj_kernels_match_plain(dev, monkeypatch):
    """render_traj (F = 3) at K = 128, M = 8, as the trainer's line set is
    drawn, through K1/K4 and through the plain versions."""
    from gflow_tpu_torch.ops.render import RenderConfig, render_traj

    args = _traj_scene(dev)
    cfg = RenderConfig(max_per_tile=128, max_tiles_per_gaussian=8)
    _build.LAUNCHES.clear()
    got = render_traj(*args, 0.0, 96, 64, 16, 0.5, 2.0, cfg, n_actual=300)
    assert _build.LAUNCHES["composite_fwd"] == 1 and _build.LAUNCHES["bin_tail"] == 1
    monkeypatch.setattr(cuda_raster, "packed_composite", composite.composite_packed)
    monkeypatch.setattr(binning, "bin_tail", binning.bin_tail_plain)
    want = render_traj(*args, 0.0, 96, 64, 16, 0.5, 2.0, cfg, n_actual=300)
    assert float(want.max()) > 0.1
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("outputs,F", [(("rgb", "center", "depth_map_color"), 6),
                                       (("rgb", "depth_map", "acc"), 5)])
def test_forward_kernel_on_diagnostic_render_input(dev, monkeypatch, outputs, F):
    """K1 at K = 192 on the packed input of the trainer's diagnostic render
    (F = 6 and the center view's F = 3) and of the final forward's F = 5
    (rgb, depth, the t_final ones channel)."""
    from gflow_tpu_torch.ops.render import RenderConfig, render

    rng = np.random.default_rng(11)
    n, Wd, Hd = 2000, 160, 96
    z = rng.uniform(2, 5, n)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    arrays = (t(np.c_[rng.uniform(-0.8, 0.8, (n, 2)) * z[:, None], z]),
              t(rng.uniform(0.02, 0.1, (n, 3))), t(rng.normal(size=(n, 4))),
              t(rng.uniform(0.3, 0.95, (n, 1))), t(rng.uniform(0, 1, (n, 3))),
              t([80.0, 80.0, Wd / 2, Hd / 2]), torch.eye(3, 4, device=dev))
    calls, packed = [], cuda_raster.packed_composite

    def record(g_attrs, counts, bg, n_tx, with_cov=False):
        calls.append((g_attrs.detach().clone(), counts.clone(), bg.clone(), n_tx))
        return packed(g_attrs, counts, bg, n_tx, with_cov)

    monkeypatch.setattr(cuda_raster, "packed_composite", record)
    render(*arrays, 0.1, Wd, Hd, outputs, RenderConfig(max_per_tile=192,
                                                       max_tiles_per_gaussian=16))
    widths = sorted(c[0].shape[2] - 6 for c in calls)
    assert F in widths and all(c[0].shape[1] == 192 for c in calls), widths
    for g_attrs, counts, bg, n_tx in calls:
        assert int(counts.max()) > 0
        got = cuda_raster.composite_fwd(g_attrs, counts, bg, n_tx)
        want = composite.composite_packed(g_attrs, counts, bg, n_tx)
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


def test_trainer_stage_with_rebin_matches_plain(dev, monkeypatch):
    """One GFlowTrainer full stage with rebin_every=2 on the card, through
    the kernels and through the plain versions (deterministic algorithms):
    the loss traces agree to rtol 1e-2, as chip_smoke.py holds them."""
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

    rng = np.random.default_rng(12)
    Hd, Wd = 64, 96
    yy, xx = np.meshgrid(np.linspace(0, 1, Hd), np.linspace(0, 1, Wd), indexing="ij")
    img = np.clip(np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 0.05, (Hd, Wd, 3)),
                  0.02, 0.98).astype(np.float32)
    depth = (1.5 + xx + rng.uniform(0, 1e-3, (Hd, Wd))).astype(np.float32)
    traces = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            if plain:
                monkeypatch.setattr(cuda_raster, "packed_composite", composite.composite_packed)
                monkeypatch.setattr(binning, "bin_tail", binning.bin_tail_plain)
            tr = GFlowTrainer(img, depth, num_points=800, make_logs=False, rebin_every=2)
            tr.init_gaussians_from_image()
            _build.LAUNCHES.clear()
            tr.train(iterations=12, lr=1e-2, lambda_depth=0.1, lambda_var=50.0)
            if not plain:
                # a binning every 2nd iteration, the final forward's, and one
                # per diagnostic render (full, still and move views)
                assert _build.LAUNCHES["bin_tail"] == 6 + 1 + 3
            traces.append(tr._last_info["loss_trace"].cpu())
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(traces[0], traces[1], rtol=1e-2, atol=1e-5)


def test_eval_render_two_class_matches_plain(dev, monkeypatch):
    """The benchmark's tracking render (uv, depth, depth_map, acc: K1 at F
    = 2, K = 128) after two-class binning (M = 48, small grid 8), as
    RenderConfig.for_scene picks for wide grids, through K1/K4 and through
    the plain versions."""
    import collections

    from gflow_tpu_torch.ops.render import RenderConfig, render

    rng = np.random.default_rng(13)
    n, Wd, Hd = 3000, 320, 192
    z = rng.uniform(2, 5, n)
    big = rng.uniform(size=(n, 1)) < 0.05  # a share outgrows the small grid
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    arrays = (t(np.c_[rng.uniform(-0.8, 0.8, (n, 2)) * z[:, None], z]),
              t(rng.uniform(0.01, 0.04, (n, 3)) * np.where(big, 8.0, 1.0)),
              t(rng.normal(size=(n, 4))), t(rng.uniform(0.3, 0.95, (n, 1))),
              t(rng.uniform(0, 1, (n, 3))), t([240.0, 240.0, Wd / 2, Hd / 2]),
              torch.eye(3, 4, device=dev))
    cfg = RenderConfig(max_per_tile=128, max_tiles_per_gaussian=48, small_tiles_per_gaussian=8)
    outputs = ("uv", "depth", "depth_map", "acc")
    shapes, packed = collections.Counter(), cuda_raster.packed_composite

    def tally(g_attrs, counts, bg, n_tx, with_cov=False):
        shapes[tuple(g_attrs.shape[1:])] += 1
        return packed(g_attrs, counts, bg, n_tx, with_cov)

    monkeypatch.setattr(cuda_raster, "packed_composite", tally)
    _build.LAUNCHES.clear()
    got = render(*arrays, 0.0, Wd, Hd, outputs, cfg)
    assert dict(_build.LAUNCHES) == {"bin_tail": 1, "composite_fwd": 1}
    assert dict(shapes) == {(128, 8): 1}  # K = 128, CA = 6 + F, F = 2
    monkeypatch.setattr(cuda_raster, "packed_composite", composite.composite_packed)
    monkeypatch.setattr(binning, "bin_tail", binning.bin_tail_plain)
    want = render(*arrays, 0.0, Wd, Hd, outputs, cfg)
    assert float(want["acc"].max()) > 0.5
    for k in outputs:
        torch.testing.assert_close(got[k], want[k], atol=5e-4, rtol=1e-3)


def test_lpips_on_the_card_matches_the_cpu(dev, monkeypatch):
    """LPIPS(Alex) on the card, with cuDNN's TF32 allowed globally (the
    library default), against the CPU: its convolutions run without TF32,
    so the two agree to 1e-5 relative."""
    from gflow_tpu_torch.eval import lpips_convert
    from gflow_tpu_torch.eval.metrics import lpips

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(14)
    sd = {k: rng.normal(0, 0.05, s).astype(np.float32)
          for k, s in lpips_convert.expected_torch_keys().items()}
    w = lpips_convert.convert(merged_sd={k: np.abs(v) if k.endswith(".bias") else v
                                         for k, v in sd.items()})
    a = rng.uniform(0, 1, (120, 200, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got, want = lpips(a, b, w, device=dev), lpips(a, b, w, device="cpu")
    assert want > 0 and got == pytest.approx(want, rel=1e-5)
    assert torch.backends.cudnn.allow_tf32  # the caller's flag is left as it was


def _fp32_guard_left_flags(monkeypatch):
    """Allow TF32 globally (cuDNN's default, and a caller's matmul
    setting): the prior models' forwards must still run in fp32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def test_gmflow_on_the_card_matches_the_cpu(dev, monkeypatch):
    """GMFlow (2 layers, 2 refinements, 32 channels; seeded weights x0.5) on
    a 64x96 pair: the card against the CPU to the JAX parity test's 5e-4
    / 1e-3, with TF32 allowed outside the model, and no K1-K4 launch."""
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert

    _fp32_guard_left_flags(monkeypatch)
    model = GMFlow(GMFlowConfig(feature_channels=32, num_transformer_layers=2,
                                num_reg_refine=2, attn_splits_list=(2, 4))).eval()
    model.load_state_dict(seeded_state_dict(convert.expected_torch_keys(2, 32), 0, 0.5))
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32))
            for _ in range(2))
    with torch.inference_mode():
        want = model(a, b)
        _build.LAUNCHES.clear()
        got = model.to(dev)(a.to(dev), b.to(dev)).cpu()
    assert not any(_build.LAUNCHES.values())
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_mast3r_on_the_card_matches_the_cpu(dev, monkeypatch):
    """MASt3R catmlp+dpt (encoder 32, decoder 24, depth 2; seeded weights
    x0.3) on a 48x32 pair: the card against the CPU to the JAX parity
    test's 2e-4 / 1e-3, with TF32 allowed outside the model."""
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict

    _fp32_guard_left_flags(monkeypatch)
    model = Mast3rModel(Mast3rConfig(enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=24,
                                     dec_depth=2, dec_heads=2, desc_dim=6,
                                     head="catmlp+dpt")).eval()
    sd = seeded_state_dict(convert.expected_torch_keys(2, 2, 32, 24, 16, "catmlp+dpt", 6), 0, 0.3)
    model.load_state_dict({k: v for k, v in sd.items() if "refinenet4.resConfUnit1" not in k})
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 48, 32, 3)).astype(np.float32))
            for _ in range(2))
    with torch.inference_mode():
        want = model(a, b)
        got = model.to(dev)(a.to(dev), b.to(dev))
    for g, w in zip(got, want):
        for k in w:
            torch.testing.assert_close(g[k].cpu(), w[k], atol=2e-4, rtol=1e-3)


def rigid_flow(H, W):
    """Forward flow (H, W, 2) of a rigid scene (smooth depth) under a
    rotating and translating camera."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    Z = 3 + np.sin(xx / 23) * np.cos(yy / 17)
    f = 0.9 * W
    P = np.stack([(xx - W / 2) * Z / f, (yy - H / 2) * Z / f, Z], -1)
    th = 0.03
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    Q = P @ R.T + np.array([0.15, 0.05, 0.1])
    return np.stack([f * Q[..., 0] / Q[..., 2] + W / 2 - xx,
                     f * Q[..., 1] / Q[..., 2] + H / 2 - yy], -1).astype(np.float32)


def test_epipolar_on_the_card_matches_the_cpu(dev):
    """The LMedS on the card with the CPU's draws, on a rigid scene's flow
    with a block moving against it: normalized error maps within 1e-3 and
    the same moving mask."""
    from gflow_tpu_torch.ops.epipolar import lmeds_draws
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map

    H, W = 120, 160
    flow = rigid_flow(H, W)
    block = (slice(40, 60), slice(50, 80))
    flow[block] = (-6.0, 4.0)
    draws = lmeds_draws(H * W)
    got = epipolar_error_map(flow, device=dev, draws=draws)
    want = epipolar_error_map(flow, device="cpu", draws=draws)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got > 0.01, want > 0.01)
    assert (got[block] > 0.01).all() and (got > 0.01).mean() < 0.1


def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs: a launch on a card that is not the current one")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_launch_on_a_card_that_is_not_current(dev):
    """K1 and K3 on tensors on cuda:1 while cuda:0 is current launch on
    cuda:1's stream and equal the same calls made with cuda:1 current; a
    launch whose tensors span two cards raises."""
    c0, c1 = two_cards()
    attrs, counts, bg = packed(c1, seed=4)
    g = torch.randn(attrs.shape[0], 256, 4, device=c1)
    with torch.cuda.device(c1):
        want = (cuda_raster.composite_fwd(attrs, counts, bg, 4),
                cuda_raster.composite_bwd(attrs, counts, bg, g, 4))
    with torch.cuda.device(c0):
        got = (cuda_raster.composite_fwd(attrs, counts, bg, 4),
               cuda_raster.composite_bwd(attrs, counts, bg, g, 4))
        torch.cuda.synchronize(c1)
    assert got[0].device == c1 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], composite.composite_packed(attrs, counts, bg, 4),
                               atol=5e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="one device"):
        _build.launch("composite_fwd", counts, attrs.to(c0), bg, attrs, 1, 1, 1, 1, 1)


def test_sharded_batch_apply_over_two_cards(dev):
    """One replica per card (the second a copy), chunks back on the first."""
    from gflow_tpu_torch.parallel.mesh import make_mesh, sharded_batch_apply

    c0, c1 = two_cards()
    model = torch.nn.Conv2d(3, 5, 3, padding=1).to(c0).eval()
    run = sharded_batch_apply(model, make_mesh(2, data_parallel=2, device="cuda"))
    assert run.devices == (c0, c1)
    x = torch.randn(4, 3, 16, 12, device=c0)
    with torch.inference_mode():
        got, want = run(x), model(x)
    assert got.device == c0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("Wd,Hd,n", [(80, 48, 300), (854, 480, 32_000)],
                         ids=["80x48", "854x480"])
def test_band_compositor_matches_unbanded_kernel(dev, with_cov, Wd, Hd, n):
    """The band wrappers on 4 bands (over the visible cards, round robin)
    against the unbanded kernel call on the same per-Gaussian inputs, at
    80x48 (3 tile rows: the fourth band is padding) and at the fit's
    854x480 (30 tile rows padded to 32: 8 a band, the last with 2 of
    padding), the focal length and the point count scaled with the width
    and the area: images and coverage atol 5e-4 / rtol 1e-3, gradients
    normalized by max |ref| 5e-4; K1 or K2 and K3 launch once per band."""
    from gflow_tpu_torch.ops.binning import bin_gaussians, tile_grid
    from gflow_tpu_torch.ops.projection import project_gaussians

    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    xyz = t(np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))])
    f = Wd / 2
    proj = project_gaussians(xyz, t(rng.uniform(0.02, 0.1, (n, 3))), t(rng.normal(size=(n, 4))),
                             t([f, f, Wd / 2, Hd / 2]), torch.eye(3, 4, device=dev), Wd, Hd)
    bins = bin_gaussians(proj["uv"], proj["depth"], proj["radius"], Wd, Hd, 64, 16)
    n_tx, n_ty = tile_grid(Wd, Hd)
    base = [proj["uv"], proj["conic"], t(rng.uniform(0.2, 0.9, (n, 1))), t(rng.uniform(0, 1, (n, 3)))]
    if with_cov:
        base.append(t(rng.uniform(size=(n, 1)) < 0.4))
    bands = tuple(torch.device("cuda", b % torch.cuda.device_count()) for b in range(4))
    G = torch.randn(Hd, Wd, 3, device=dev)
    outs = []
    for banded in (True, False):
        xs = [x.detach().clone().requires_grad_(i < 4) for i, x in enumerate(base)]
        args = (bins.tile_lists, *xs, 0.3, Wd, Hd, n_tx, n_ty)
        _build.LAUNCHES.clear()
        if with_cov:
            fn = (cuda_raster.composite_with_coverage_kernel_sharded if banded
                  else cuda_raster.composite_with_coverage_kernel)
            img, cov = fn(*args, *((bands,) if banded else ()), tile_counts=bins.tile_counts)
        else:
            fn = (cuda_raster.composite_tiles_kernel_sharded if banded
                  else cuda_raster.composite_tiles_kernel)
            img, cov = fn(*args, *((bands,) if banded else ()), tile_counts=bins.tile_counts), None
        grads = torch.autograd.grad((img * G).sum(), xs[:4])
        torch.cuda.synchronize()
        outs.append((img, cov, grads, dict(_build.LAUNCHES)))
    (img_b, cov_b, g_b, l_b), (img_u, cov_u, g_u, l_u) = outs
    assert img_b.device == img_u.device == bins.tile_lists.device and img_b.shape == (Hd, Wd, 3)
    torch.testing.assert_close(img_b, img_u, atol=5e-4, rtol=1e-3)
    if with_cov:
        torch.testing.assert_close(cov_b, cov_u, atol=5e-4, rtol=1e-3)
    for gb, gu in zip(g_b, g_u):
        assert float(((gb - gu) / gu.abs().max()).abs().max()) <= 5e-4
    fwd = "composite_fwd_cov" if with_cov else "composite_fwd"
    assert l_b == {fwd: 4, "composite_bwd": 4} and l_u == {fwd: 1, "composite_bwd": 1}


def graph_stage_inputs(dev, seed=0, Wd=96, Hd=64, n=800, capacity=1024):
    """A small first-frame stage on the card: points from a smooth image,
    an occluded region for the occ densify."""
    from gflow_tpu_torch.opt.initialize import init_params_from_image
    from gflow_tpu_torch.opt.state import Targets, init_frame_state

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, Hd), np.linspace(0, 1, Wd), indexing="ij")
    img = np.clip(np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 0.05, (Hd, Wd, 3)),
                  0.02, 0.98).astype(np.float32)
    depth = (1.5 + xx + rng.uniform(0, 1e-3, (Hd, Wd))).astype(np.float32)
    intr = np.asarray([80.0, 80.0, Wd / 2, Hd / 2], np.float32)
    params, n0 = init_params_from_image(img, depth, n, capacity, intr,
                                        np.c_[np.eye(3), np.zeros(3)].astype(np.float32),
                                        rng=rng, device=dev)
    state = init_frame_state(capacity, dev)._replace(
        n_alive=torch.tensor(n0, dtype=torch.int32, device=dev))
    occ = np.zeros((Hd, Wd), bool)
    occ[10:30, 20:50] = True
    move = np.zeros((Hd, Wd), bool)
    move[30:50, 40:70] = True
    targets = Targets(torch.from_numpy(img).to(dev), torch.from_numpy(depth)[..., None].to(dev),
                      torch.zeros((Hd, Wd, 2), device=dev), torch.from_numpy(move).to(dev),
                      torch.from_numpy(occ).to(dev))
    return params, state, targets, torch.from_numpy(intr).to(dev)


GRAPH_PATHS = {
    "lean": dict(densify_occ=True, densify_interval=4, densify_times=1, max_densify=64),
    "rebin": dict(rebin_every=3, densify_occ=True, densify_interval=4, densify_times=1,
                  max_densify=64),
    "snapshot": dict(snapshot_every=3, densify_occ=True, densify_interval=4, densify_times=1,
                     max_densify=64),
    "camera": dict(camera_only=True),
    # the lean path at the K the fit escalates to (the fit cell's K)
    "lean_k192": dict(densify_occ=True, densify_interval=4, densify_times=1, max_densify=64,
                      max_per_tile=192),
}


def graph_stage(dev, path, graphs, seed=0, stamps=False):
    from gflow_tpu_torch.ops.render import RenderConfig
    from gflow_tpu_torch.opt.losses import LossWeights
    from gflow_tpu_torch.opt.train import StageConfig, StageDynamics, train_stage

    params, state, targets, intr = graph_stage_inputs(dev, seed)
    kw = dict(GRAPH_PATHS[path])
    K = kw.pop("max_per_tile", 64)
    cfg = StageConfig(W=96, H=64, iterations=8, telemetry_t_final=path == "lean",
                      render=RenderConfig(max_per_tile=K, max_tiles_per_gaussian=16),
                      stamps=stamps, **kw)
    dyn = StageDynamics(lr=1e-2, lr_camera=1e-3, num_points=800, densify_occ_percent=0.5,
                        weights=LossWeights(rgb=1.0, depth=0.1, var=50.0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return train_stage(params, state, targets, intr, gen, cfg, dyn, graphs=graphs)


def flat_outputs(out):
    params, state, info = out
    flat = {f"params.{k}": v for k, v in params._asdict().items()}
    flat.update({f"state.{k}": v for k, v in state._asdict().items()})
    for k, v in info.items():
        for m, x in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"info.{k}.{m}"] = x
    return flat


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graphed_stage_equals_eager(dev, path):
    """train_stage as CUDA graphs against the same stage eager
    (disable_graphs), deterministic algorithms on: every output 0 apart,
    the same kernel launches (the graphs' counted at each replay), no
    synchronising call inside the replays (train_stage replays under
    set_sync_debug_mode("error")); then a second frame through the same
    graphs, and one replay of the step graph alone under the sync check."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    cache = stage_graphs.GraphCache()
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed, seed in ((False, 0), (True, 0), (False, 1), (True, 1)):
            _build.LAUNCHES.clear()
            stage_graphs.REPLAYS.clear()
            with contextlib.nullcontext() if graphed else stage_graphs.disable_graphs():
                out = graph_stage(dev, path, cache, seed)
            torch.cuda.synchronize()
            runs.append((flat_outputs(out), dict(_build.LAUNCHES), dict(stage_graphs.REPLAYS)))
    finally:
        torch.use_deterministic_algorithms(False)
    for (eager, l_e, r_e), (graphed, l_g, r_g) in (runs[:2], runs[2:]):
        assert set(eager) == set(graphed)
        diff = {k: float((eager[k].double() - graphed[k].double()).abs().max())
                for k in eager if eager[k].numel()}
        assert not any(diff.values()), diff
        assert l_g == l_e and set(l_e) >= {"bin_tail", "composite_bwd"}, (l_g, l_e)
        assert not r_e and r_g["step"] == 8, r_g
    assert len(cache.entries) == 1
    (entry,) = cache.entries.values()
    entry.buffers.it.zero_()  # the stage left its iteration counter at the end
    with stage_graphs.sync_check(dev):
        entry.graphs["step"].replay()
    torch.cuda.synchronize()


@pytest.mark.parametrize("graphed", [True, False])
def test_stamped_stage_pieces_and_same_losses(dev, graphed):
    """A full stage with stamps (what a trainer with telemetry runs), as
    CUDA graphs and eagerly (disable_graphs: the same stamp kernel): every
    piece of every iteration is positive on the card's timer, and the
    stamp kernel ran five times an iteration; the same stage without
    stamps gives the same loss trace and parameters exactly,
    deterministic algorithms on (a stamp writes only its own table)."""
    from gflow_tpu_torch.ops.stamp import COLS, pieces
    from gflow_tpu_torch.opt import graphs as stage_graphs

    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for stamps in (True, False):
            _build.LAUNCHES.clear()
            with contextlib.nullcontext() if graphed else stage_graphs.disable_graphs():
                out = graph_stage(dev, "lean", stage_graphs.GraphCache(), 0, stamps=stamps)
            torch.cuda.synchronize()
            runs[stamps] = (out, dict(_build.LAUNCHES))
    finally:
        torch.use_deterministic_algorithms(False)
    (params, _, info), launches = runs[True]
    (params0, _, info0), launches0 = runs[False]
    table = info["stamps"].cpu().numpy()
    assert table.shape == (8, COLS) and "stamps" not in info0
    assert (np.diff(table, axis=1) > 0).all(), table
    assert (table[1:, 0] >= table[:-1, -1]).all(), table
    assert all(pieces(table)[k] > 0 for k in ("render", "loss", "backward", "update"))
    assert launches.pop("stamp") == 8 * COLS and launches == launches0
    assert torch.equal(info["loss_trace"], info0["loss_trace"])
    for a, b in zip(params, params0):
        assert torch.equal(a, b)


def test_failed_capture_raises(dev, monkeypatch):
    """A synchronising call inside the recorded region fails the capture,
    and train_stage raises: nothing falls back to the eager loop."""
    from gflow_tpu_torch.opt import graphs as stage_graphs
    from gflow_tpu_torch.opt import train as ttrain

    gate = ttrain._gate_grads

    def syncing_gate(grads, state, n_alive, camera_only):
        int(n_alive)  # a device-to-host read
        return gate(grads, state, n_alive, camera_only)

    monkeypatch.setattr(ttrain, "_gate_grads", syncing_gate)
    with pytest.raises(RuntimeError):
        graph_stage(dev, "camera", stage_graphs.GraphCache())
    torch.cuda.synchronize()


def flat_arrays(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_arrays(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for x in tree for a in flat_arrays(x)]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return [np.asarray(tree, np.float64)]


def graph_vs_eager(call, checked=False, launched=("bin_tail", "composite_fwd")):
    """call() as CUDA graphs (under sync_check("error") with checked) and
    inside disable_graphs(), deterministic algorithms on: 0 apart, the same
    kernel launches, `launched` among them. Returns the graphed run's
    replays per graph name."""
    from gflow_tpu_torch.opt import graphs as stage_graphs

    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (True, False):
            _build.LAUNCHES.clear()
            stage_graphs.REPLAYS.clear()
            with contextlib.ExitStack() as stack:
                if not graphed:
                    stack.enter_context(stage_graphs.disable_graphs())
                elif checked:
                    stack.enter_context(stage_graphs.sync_check(torch.device("cuda")))
                out = call()
            torch.cuda.synchronize()
            runs.append((flat_arrays(out), dict(_build.LAUNCHES), dict(stage_graphs.REPLAYS)))
    finally:
        torch.use_deterministic_algorithms(False)
    (g, l_g, r_g), (e, l_e, r_e) = runs
    assert [a.shape for a in g] == [a.shape for a in e]
    assert all(np.array_equal(a, b) for a, b in zip(g, e))
    assert l_g == l_e and set(l_g) >= set(launched), (l_g, l_e)
    assert r_g and not r_e, (r_g, r_e)
    return r_g


def test_graphed_renders_equal_eager(dev):
    """render_jit, render_traj_jit at two counts (one graph), render2img,
    and a fitted trainer's diagnostic views, trajectory image, project_points
    and gather_project, each as CUDA graphs against eager: 0 apart, the
    same launches."""
    from gflow_tpu_torch.ops.render import RenderConfig, render2img, render_jit, render_traj_jit
    from gflow_tpu_torch.pipeline.trainer import GFlowTrainer

    args = _traj_scene(dev)
    cfg = RenderConfig(max_per_tile=128, max_tiles_per_gaussian=8)
    assert graph_vs_eager(lambda: render_jit(*args, 0.1, 96, 64, config=cfg)) == {"render": 1}
    assert graph_vs_eager(lambda: [render_traj_jit(*args, 0.0, 96, 64, 16, 0.5, 2.0, cfg,
                                                   n_actual=n) for n in (300, 120)]) == {
        "render_traj": 2}
    img = render_jit(*args, 0.1, 96, 64, ("rgb",), cfg)["rgb"]
    graph_vs_eager(lambda: (render2img(img), render_jit(*args, 0.1, 96, 64, ("rgb",), cfg)))

    rng = np.random.default_rng(12)
    Hd, Wd = 64, 96
    yy, xx = np.meshgrid(np.linspace(0, 1, Hd), np.linspace(0, 1, Wd), indexing="ij")
    image = np.clip(np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 0.05, (Hd, Wd, 3)),
                    0.02, 0.98).astype(np.float32)
    depth = (1.5 + xx + rng.uniform(0, 1e-3, (Hd, Wd))).astype(np.float32)
    tr = GFlowTrainer(image, depth, num_points=800, make_logs=False)
    tr.init_gaussians_from_image()
    tr.train(iterations=4, lr=1e-2, lambda_depth=0.1)
    query = np.arange(0, 800, 50)
    tr.eval(query, need_center_depth=False)  # the trajectory line set's first frame
    tr.train(iterations=4, lr=1e-2, lambda_depth=0.1)
    tr.eval(query, need_center_depth=False)
    assert graph_vs_eager(tr._diag_views) == {"diag": 1}
    assert graph_vs_eager(lambda: (tr.traj_image(16, 0.1, 0.3),
                                   tr.traj_image(16, 0.1, 0.3, as_uint8=True))) == {"traj": 2}
    pts = tr.params.xyz[:100].cpu().numpy()
    graph_vs_eager(lambda: (tr.project_points(pts), tr.gather_project(query),
                            tr.render_views()))


@pytest.mark.parametrize("Wd,Hd,n", [(320, 192, 3000), (854, 480, 20_000)],
                         ids=["320x192", "854x480"])
def test_two_class_render_captures_under_sync_check(dev, Wd, Hd, n):
    """The benchmark's tracking render after two-class binning (M = 48,
    small grid 8, K = 128) records and replays as a CUDA graph with every
    synchronising call an error, and equals the eager render; at 320x192
    and at the eval's 854x480 (the focal length and the point count scaled
    with the width and the area)."""
    from gflow_tpu_torch.ops.render import RenderConfig, render_jit

    rng = np.random.default_rng(13)
    z = rng.uniform(2, 5, n)
    big = rng.uniform(size=(n, 1)) < 0.05
    f = 0.75 * Wd
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    arrays = (t(np.c_[rng.uniform(-0.8, 0.8, (n, 2)) * z[:, None], z]),
              t(rng.uniform(0.01, 0.04, (n, 3)) * np.where(big, 8.0, 1.0)),
              t(rng.normal(size=(n, 4))), t(rng.uniform(0.3, 0.95, (n, 1))),
              t(rng.uniform(0, 1, (n, 3))), t([f, f, Wd / 2, Hd / 2]),
              torch.eye(3, 4, device=dev))
    cfg = RenderConfig(max_per_tile=128, max_tiles_per_gaussian=48, small_tiles_per_gaussian=8)
    call = lambda: render_jit(*arrays, 0.0, Wd, Hd, ("uv", "depth", "depth_map", "acc"), cfg)
    assert graph_vs_eager(call, checked=True) == {"render": 1}


def banded_graph_stage(dev, bands, seed=0):
    from gflow_tpu_torch.ops.render import RenderConfig
    from gflow_tpu_torch.opt.losses import LossWeights
    from gflow_tpu_torch.opt.train import StageConfig, StageDynamics, train_stage

    params, state, targets, intr = graph_stage_inputs(dev, seed)
    cfg = StageConfig(W=96, H=64, iterations=8, densify_occ=True, densify_interval=4,
                      densify_times=1, max_densify=64,
                      render=RenderConfig(max_per_tile=64, max_tiles_per_gaussian=16,
                                          band_devices=bands))
    dyn = StageDynamics(lr=1e-2, lr_camera=1e-3, num_points=800, densify_occ_percent=0.5,
                        weights=LossWeights(rgb=1.0, depth=0.1, var=50.0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return train_stage(params, state, targets, intr, gen, cfg, dyn)


def check_banded_stage_graphs(dev, bands):
    """The banded stage as CUDA graphs against eager, 0 apart with the same
    launches and a step replay per iteration; and against the unbanded
    stage to 1e-6."""
    replays = graph_vs_eager(lambda: flat_outputs(banded_graph_stage(dev, bands)))
    assert replays == {"step": 8}, replays
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        banded = flat_outputs(banded_graph_stage(dev, bands))
        unbanded = flat_outputs(banded_graph_stage(dev, None))
    finally:
        torch.use_deterministic_algorithms(False)
    for k in ("params.xyz", "params.rgb", "info.loss_trace."):
        torch.testing.assert_close(banded[k], unbanded[k], atol=1e-6, rtol=1e-6)


def test_banded_stage_on_one_card_replays_graphs(dev):
    check_banded_stage_graphs(dev, (torch.device("cuda", 0),) * 4)


def test_banded_stage_over_cards_replays_graphs(dev):
    """The bands over every visible card, round robin: one capture spans
    the cards' streams."""
    two_cards()
    n = torch.cuda.device_count()
    check_banded_stage_graphs(dev, tuple(torch.device("cuda", b % n) for b in range(4)))


def separated_symmetric(n, batch, seed=0):
    """Seeded symmetric (batch, n, n) float32 matrices Q diag(l) Q^T whose
    smallest eigenvalue lies 0.1-0.6 below the next."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(batch, n, n)))[0]
    lam = np.sort(rng.uniform(-1, 1, (batch, n)), axis=1)
    if n > 1:
        lam[:, 0] = lam[:, 1] - 0.1 - rng.uniform(0, 0.5, batch)
    return torch.from_numpy(((Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32))


def eig_residual(v, A):
    """|A v - l v| / |A| per matrix, l = v^T A v."""
    lam = torch.einsum("bi,bij,bj->b", v, A, v)
    return torch.linalg.vector_norm(A @ v[..., None] - lam[:, None, None] * v[..., None],
                                    dim=(1, 2)) / torch.linalg.matrix_norm(A)


@pytest.mark.parametrize("batch", [1, 33, 512])
@pytest.mark.parametrize("n", range(1, 10))
def test_small_eig_matches_plain(dev, n, batch):
    """The kernel's eigenvector has a residual |A v - l v| / |A| <= 1e-5
    (l = v^T A v) and agrees with eigh's up to sign; one launch. n < 5 runs
    one thread per matrix, n >= 5 one warp per matrix."""
    from gflow_tpu_torch.ops import epipolar

    A = separated_symmetric(n, batch).to(dev)
    _build.LAUNCHES.clear()
    v = epipolar.small_eig(A)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"small_eig": 1}
    res = eig_residual(v, A)
    dot = (v * epipolar.smallest_eigvec_plain(A)).sum(-1).abs()
    assert float(res.max()) <= 1e-5 and float(dot.min()) >= 1 - 1e-5, (res.max(), dot.min())


@pytest.mark.parametrize("n", [3, 9])
def test_small_eig_repeated_smallest_eigenvalue(dev, n):
    """The smallest eigenvalue twice: the residual is held and v lies in its
    eigenspace (|P v| >= 1 - 1e-5, P the projection onto it)."""
    from gflow_tpu_torch.ops import epipolar

    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.normal(size=(64, n, n)))[0]
    lam = np.sort(rng.uniform(-1, 1, (64, n)), axis=1)
    lam[:, 2:] = np.maximum(lam[:, 2:], lam[:, :1] + 0.2)
    lam[:, 1] = lam[:, 0]
    A = torch.from_numpy(((Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32))
    v = epipolar.small_eig(A.to(dev)).cpu().double()
    assert float(eig_residual(v, A.double()).max()) <= 1e-5
    inside = torch.linalg.vector_norm(torch.einsum("bij,bi->bj", torch.from_numpy(Q[:, :, :2]), v),
                                      dim=-1)
    assert float(inside.min()) >= 1 - 1e-5, inside.min()


@pytest.mark.parametrize("n", [3, 9])
def test_small_eig_zero_and_identity(dev, n):
    """The zero matrix and the identity (every rotation skipped): a finite
    unit vector."""
    from gflow_tpu_torch.ops import epipolar

    A = torch.stack([torch.zeros(n, n), torch.eye(n)]).to(dev)
    v = epipolar.small_eig(A)
    assert bool(torch.isfinite(v).all())
    torch.testing.assert_close(torch.linalg.vector_norm(v, dim=-1), torch.ones(2, device=dev))


@pytest.mark.parametrize("n", [3, 9])
def test_small_eig_nan_matrix_leaves_the_batch(dev, n):
    """One matrix of NaNs in a batch of 33: the kernel returns, and every
    other matrix's eigenvector equals that of the batch without it."""
    from gflow_tpu_torch.ops import epipolar

    A = separated_symmetric(n, 33, seed=4).to(dev)
    A[7] = float("nan")
    v = epipolar.small_eig(A)
    torch.cuda.synchronize()
    keep = [i for i in range(33) if i != 7]
    assert torch.equal(v[keep], epipolar.small_eig(A[keep]))


def test_graphed_lmeds_equals_eager_under_sync_check(dev):
    """The LMedS on a rigid scene's flow (rigid_flow, a block moving
    against it) recorded and replayed under sync_check("error"): F and the inliers
    equal eager, four small_eig launches a call (512 and 1 of 9 x 9, 512
    and 1 of 3 x 3); the error map of the plain eigh path on the card
    within 1e-2 and at most 0.1% of the mask flipped (chip_smoke.py's
    MAP_ATOL and MASK_FLIPS: the refit's null vector of a near-singular
    A^T A is float32 noise over eps |A^T A| / gap, which the two solvers
    round apart; 1.6e-3 measured at 128x96)."""
    from gflow_tpu_torch.ops import epipolar
    from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map, uv_grid

    H, W = 96, 128
    flow = rigid_flow(H, W)
    flow[30:50, 40:70] = (-6.0, 4.0)  # a block moving against the scene
    x1 = torch.from_numpy(uv_grid(H, W).reshape(-1, 2)).to(dev)
    x2 = x1 + torch.from_numpy(np.stack([2 * flow[..., 0] / (W - 1), 2 * flow[..., 1] / (H - 1)],
                                        -1).reshape(-1, 2)).to(dev)
    draws = epipolar.lmeds_draws(H * W)
    replays = graph_vs_eager(lambda: epipolar.find_fundamental_lmeds(x1, x2, draws=draws),
                             checked=True, launched=("small_eig",))
    assert replays == {"lmeds": 1}
    got = epipolar_error_map(flow, device=dev, draws=draws)
    with _plain_eig(), stage_graphs_off():
        want = epipolar_error_map(flow, device=dev, draws=draws)
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert ((got > 0.01) != (want > 0.01)).mean() <= 1e-3


@contextlib.contextmanager
def _plain_eig():
    from unittest import mock

    from gflow_tpu_torch.ops import epipolar

    with mock.patch.object(epipolar, "smallest_eigvec", epipolar.smallest_eigvec_plain):
        yield


def stage_graphs_off():
    from gflow_tpu_torch.opt import graphs as stage_graphs

    return stage_graphs.disable_graphs()


def test_graphed_alignment_equals_eager(dev):
    """The alignment's refinement (4 frames, 6 edges, 256 samples; 45 steps:
    two chunk graphs and a tail) recorded under sync_check("error") equals
    the eager loop exactly."""
    from gflow_tpu_torch.models.mast3r import alignment

    rng = np.random.default_rng(0)
    T, E, S = 4, 6, 256
    q = np.c_[rng.normal(0, 0.02, (T, 3)), np.ones(T)]
    src = rng.normal(0, 1, (E, S, 3)) + [0, 0, 3]
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(np.c_[q / np.linalg.norm(q, axis=1, keepdims=True), rng.normal(0, 0.1, (T, 3))]),
            t(rng.normal(0, 0.1, T)), t([0, 1, 2, 3, 0, 1], torch.int64),
            t([1, 2, 3, 0, 2, 3], torch.int64), t(src), t(src + rng.normal(0, 0.05, src.shape)),
            t(rng.uniform(0.5, 2.0, (E, S))))
    replays = graph_vs_eager(lambda: alignment._refine(*args, 0.07, 0.3, 45), checked=True,
                             launched=())
    assert replays == {f"adam{alignment.CHUNK}": 2, "adam5": 1, "loss": 1}, replays


def test_graphed_prep_models_equal_eager(dev):
    """GMFlow (2 layers, 2 refinements, splits 2 and 4) and MASt3R
    catmlp+dpt at small widths through prep's batch runner, recorded under
    sync_check("error"): equal to the eager forwards; a model moved to the
    card anew records anew."""
    from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel, convert as mconvert
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.unimatch import GMFlow, GMFlowConfig, convert
    from gflow_tpu_torch.pipeline import prep_depth, prep_flow

    flow = GMFlow(GMFlowConfig(feature_channels=32, num_transformer_layers=2,
                               num_reg_refine=2, attn_splits_list=(2, 4))).eval()
    flow.load_state_dict(seeded_state_dict(convert.expected_torch_keys(2, 32), 0, 0.5))
    mast3r = Mast3rModel(Mast3rConfig(enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=24,
                                      dec_depth=2, dec_heads=2, desc_dim=6,
                                      head="catmlp+dpt")).eval()
    sd = seeded_state_dict(mconvert.expected_torch_keys(2, 2, 32, 24, 16, "catmlp+dpt", 6), 0,
                           0.3)
    mast3r.load_state_dict({k: v for k, v in sd.items() if "refinenet4.resConfUnit1" not in k})
    rng = np.random.default_rng(2)
    for model, cache, hw, name in ((flow, prep_flow.FLOW_GRAPHS, (64, 96), "gmflow"),
                                   (mast3r, prep_depth.DEPTH_GRAPHS, (48, 32), "mast3r")):
        model.to(dev)
        run = prep_flow.batch_runner(model, 0, dev, cache)[0]
        a, b = (torch.from_numpy(rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)).to(dev)
                for _ in range(2))
        with torch.inference_mode():
            assert graph_vs_eager(lambda: run(a, b), checked=True, launched=()) == {name: 1}
        n = len(cache.entries)
        model.cpu().to(dev)
        with torch.inference_mode():
            run(a, b)
        assert len(cache.entries) == n + 1


def test_graphed_batched_step_equals_eager(dev):
    """sharded_train_step's step over a (2 data x 2 tile) mesh on this card,
    recorded under sync_check("error"), called twice: equal to eager, the
    band kernels launched as eagerly."""
    from gflow_tpu_torch.parallel.mesh import make_mesh
    from gflow_tpu_torch.parallel.multichip import sharded_train_step, step_inputs

    mesh = make_mesh(4, data_parallel=2, device=[torch.device("cuda", 0)] * 4)
    cfg, dyn, (p, o, st, tg, intr) = step_inputs(mesh)
    step = sharded_train_step(mesh, cfg, dyn)[0]

    def two_steps():
        q, r = p, o
        outs = []
        for _ in range(2):
            q, r, loss, rgb = step(q, r, st, tg, intr)
            outs += [q, r.m, r.v, loss, rgb]
        return outs

    assert graph_vs_eager(two_steps, checked=True) == {"train_step": 2}


def test_graphed_replicas_over_two_cards(dev):
    """sharded_batch_apply with a graph cache over two cards: one graph per
    replica on its own card, equal to the eager replicas."""
    from gflow_tpu_torch.opt.graphs import ForwardCache
    from gflow_tpu_torch.parallel.mesh import make_mesh, sharded_batch_apply

    c0, c1 = two_cards()
    model = torch.nn.Conv2d(3, 5, 3, padding=1).to(c0).eval()
    cache = ForwardCache("replica", 4)
    run = sharded_batch_apply(model, make_mesh(2, data_parallel=2, device="cuda"), cache)
    x = torch.randn(4, 3, 16, 12, device=c0)
    with torch.inference_mode():
        assert graph_vs_eager(lambda: run(x), checked=True, launched=()) == {"replica": 2}
    assert sorted(str(k[3]) for k in cache.entries) == ["cuda:0", "cuda:1"]


SSIM_SHAPES = [(480, 854, 3), (37, 23, 3), (37, 23, 1), (7, 5, 3), (7, 5, 1)]


def ssim_images(dev, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(*shape, generator=g)
    y = (0.7 * x + 0.3 * torch.rand(*shape, generator=g)).clamp(0, 1)
    return x.to(dev), y.to(dev)


def ssim_grads(fn, x, y, keep=None):
    """1 - fn(x * keep, y * keep) and its gradient with respect to x."""
    leaf = x.detach().clone().requires_grad_()
    r, t = (leaf, y) if keep is None else (leaf * keep, y * keep)
    loss = 1.0 - fn(r, t)
    return loss.detach(), torch.autograd.grad(loss, leaf)[0]


def assert_ssim_grads_close(got, want):
    """Kernel against autograd through the plain version, each in float32:
    within 1e-5 of the largest entry. The two order the same operations
    differently (the coefficient formula against autograd's chain through
    mu^2 and sigma = E[x^2] - mu^2, and the blur's sums), ~1e-7 relative
    an operation, which the cancellation in sigma amplifies up to ~10x."""
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", SSIM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssim_kernels_match_plain(dev, shape):
    """ssim_fwd: the mean within 1e-6 absolute of the plain version on the
    card (the blurred maps and the SSIM map are its float32 operations; the
    mean's summation order differs), and bitwise the same on repeat;
    ssim_bwd: dL/dimg1 of 1 - SSIM as autograd's through the plain
    version (assert_ssim_grads_close), also for images smaller than the
    window and a single channel."""
    from gflow_tpu_torch.ops import ssim as ssim_ops

    x, y = ssim_images(dev, shape)
    with torch.no_grad():
        got, want = ssim_ops.ssim(x, y), ssim_ops.ssim_plain(x, y)
        again = ssim_ops.ssim(x, y)
    torch.cuda.synchronize()
    assert abs(float(got) - float(want)) <= 1e-6, (float(got), float(want))
    assert torch.equal(got, again)
    loss_k, g_k = ssim_grads(ssim_ops.ssim, x, y)
    loss_p, g_p = ssim_grads(ssim_ops.ssim_plain, x, y)
    torch.cuda.synchronize()
    assert abs(float(loss_k) - float(loss_p)) <= 1e-6
    assert_ssim_grads_close(g_k, g_p)
    assert torch.equal(g_k, ssim_grads(ssim_ops.ssim, x, y)[1])  # no atomics


@pytest.mark.parametrize("layout", ["camera_only", "channel_slice"])
def test_ssim_kernels_on_the_fit_inputs(dev, layout):
    """The fit's own inputs at 854x480: the camera-only stage's (both
    images times the not-moving mask, the gradient through the mask) and
    the full stage's (the rendered rgb, a channel slice of the (H, W, 4)
    composite, read in place)."""
    from gflow_tpu_torch.ops import ssim as ssim_ops

    x, y = ssim_images(dev, (480, 854, 3), seed=1)
    if layout == "camera_only":
        keep = torch.ones(480, 854, 1, device=dev)
        keep[200:320, 300:460] = 0
        got, want = (ssim_grads(fn, x, y, keep) for fn in (ssim_ops.ssim, ssim_ops.ssim_plain))
    else:
        img = torch.cat([x, torch.rand(480, 854, 1, device=dev)], -1).requires_grad_()
        grads = []
        for fn in (ssim_ops.ssim, ssim_ops.ssim_plain):
            loss = 1.0 - fn(img[..., :3], y)
            grads.append((loss.detach(), torch.autograd.grad(loss, img)[0]))
        got, want = grads
        assert not got[1][..., 3].any()
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(want[0])) <= 1e-6
    assert_ssim_grads_close(got[1], want[1])


def test_ssim_no_grad_writes_no_coefficient_maps(dev):
    """Under no_grad, or for an img1 that needs no gradient, ssim_fwd gets
    a null coefficient pointer (its last argument 0); with a gradient the
    (3, H, W, C) maps; img2 requiring a gradient raises."""
    from gflow_tpu_torch.ops import ssim as ssim_ops

    x, y = ssim_images(dev, (37, 23, 3))
    seen = []
    hook = lambda name, args: seen.append((name, args[-1]))
    _build.LAUNCH_HOOKS.append(hook)
    try:
        leaf = x.clone().requires_grad_()
        with torch.no_grad():
            ssim_ops.ssim(leaf, y)
        ssim_ops.ssim(x, y)
        ssim_ops.ssim(leaf, y)
    finally:
        _build.LAUNCH_HOOKS.remove(hook)
    assert seen == [("ssim_fwd", 0), ("ssim_fwd", 0), ("ssim_fwd", (3, 37, 23, 3))]
    with pytest.raises(ValueError, match="img2"):
        ssim_ops.ssim(x, y.clone().requires_grad_())


def test_ssim_captured_equals_eager(dev):
    """1 - SSIM and its gradient captured in a CUDA graph: a replay equals
    the eager call exactly, also after new images are copied into the
    graph's inputs."""
    from gflow_tpu_torch.ops import ssim as ssim_ops

    x, y = ssim_images(dev, (480, 854, 3), seed=2)
    step = lambda: ssim_grads(ssim_ops.ssim, x, y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for seed in (2, 3):
        x2, y2 = ssim_images(dev, (480, 854, 3), seed=seed)
        x.copy_(x2)
        y.copy_(y2)
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.parametrize("path", ["lean", "camera"])
def test_ssim_kernels_once_per_iteration(dev, path):
    """A stamped stage (as CUDA graphs): ssim_bwd and ssim_fwd with its
    coefficient maps once an iteration; the no-grad forwards (the error
    densify's and the stage's final one) take ssim_fwd without them."""
    from gflow_tpu_torch.ops.stamp import COLS
    from gflow_tpu_torch.opt import graphs as stage_graphs

    coef = []
    hook = lambda name, args: coef.append(args[-1] != 0) if name == "ssim_fwd" else None
    _build.LAUNCHES.clear()
    _build.LAUNCH_HOOKS.append(hook)
    try:
        graph_stage(dev, path, stage_graphs.GraphCache(), stamps=True)
        torch.cuda.synchronize()
    finally:
        _build.LAUNCH_HOOKS.remove(hook)
    iters = _build.LAUNCHES["stamp"] // COLS
    assert iters == 8
    assert _build.LAUNCHES["ssim_bwd"] == coef.count(True) == iters
    # lean: the error densify's forward and the final one; camera: the final one
    assert coef.count(False) == (2 if path == "lean" else 1)


# SAM's mask decoder: the image stream's kernels (ops/sam_decoder.py,
# csrc/sam_decoder.cu) at the automatic grid's shapes: 64 prompts (and 1),
# a 64 x 64 grid of 256 channels, 7 tokens, cross attention 8 heads of 16.
# stream_init's adds are the plain version's bitwise; the attentions and the
# norm sum in another order (shuffle trees, the online softmax over chunks),
# ~1e-7 relative a sum, so 1e-5 of the largest value, which a wrong head,
# token, row or chunk misses by orders of magnitude.
SAM_RTOL = 1e-5


def sam_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sam_stream_inputs(dev, B, grid=64, T=7, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    N = grid * grid
    return dict(image=r(1, 256, grid, grid), dense=r(256), pe=r(N, 256),
                q_t=r(B, T, 128, scale=2.0), k_n=r(B, N, 128), v_n=r(B, N, 128),
                q_n=r(B, N, 128, scale=2.0), k_t=r(B, T, 128), v_t=r(B, T, 128),
                keys=r(B, N, 256), out=r(B, N, 256), w=r(256), b=r(256))


@pytest.mark.parametrize("B", [1, 64])
def test_sam_decoder_kernels_match_plain(dev, B):
    """Each kernel against its plain version on the card; the attentions
    and the norm bitwise repeatable (no atomics)."""
    from gflow_tpu_torch.ops import sam_decoder as sd

    x = sam_stream_inputs(dev, B)
    keys, kpe = sd.stream_init(x["image"], x["dense"], x["pe"], B)
    want_keys, want_kpe = sd.stream_init_plain(x["image"], x["dense"], x["pe"], B)
    assert keys.is_contiguous() and kpe.is_contiguous()
    assert torch.equal(keys, want_keys) and torch.equal(kpe, want_kpe)
    for fn, args in ((sd.t2i_attend, (x["q_t"], x["k_n"], x["v_n"])),
                     (sd.i2t_attend, (x["q_n"], x["k_t"], x["v_t"]))):
        got = fn(*args, 8)
        want = sd.cross_attend_plain(*args, 8)
        assert got.shape == want.shape and sam_rel(got, want) <= SAM_RTOL, fn.__name__
        assert torch.equal(got, fn(*args, 8)), fn.__name__
    got = sd.residual_ln(x["keys"], x["out"], x["w"], x["b"], 1e-5, x["pe"])
    want = sd.residual_ln_plain(x["keys"], x["out"], x["w"], x["b"], 1e-5, x["pe"])
    for a, b in zip(got, want):
        assert sam_rel(a, b) <= SAM_RTOL
    torch.cuda.synchronize()


def test_sam_t2i_over_ragged_chunks_and_every_token_count(dev):
    """Token to image over N that no chunk divides (a chunk and a warp
    with few or no keys) and 1 to 8 tokens; image to token the same."""
    from gflow_tpu_torch.ops import sam_decoder as sd

    g = torch.Generator(device=dev).manual_seed(3)
    for N in (1, 37, 300, 4100):
        for T in range(1, 9):
            q = torch.randn(3, T, 128, generator=g, device=dev) * 2
            k, v = (torch.randn(3, N, 128, generator=g, device=dev) for _ in range(2))
            got = sd.t2i_attend(q, k, v, 8)
            assert sam_rel(got, sd.cross_attend_plain(q, k, v, 8)) <= SAM_RTOL, (N, T)
            got = sd.i2t_attend(k, q, q * 0.5, 8)
            assert sam_rel(got, sd.cross_attend_plain(k, q, q * 0.5, 8)) <= SAM_RTOL, (N, T)
    torch.cuda.synchronize()


def sam_decoder_model(dev, scale=1.0, seed=0):
    """SAM with its released decoder (256 wide, 8 heads, cross attention at
    128) over a 64 x 64 grid, a 2-block 64-wide encoder (never run here)."""
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.sam import SamConfig, SamModel, convert

    cfg = SamConfig(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
                    encoder_global_attn_indexes=(1,))
    sd = seeded_state_dict(convert.expected_torch_keys(cfg), seed, scale)
    key = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    sd[key] = torch.randn(sd[key].shape, generator=torch.Generator().manual_seed(seed + 1))
    model = SamModel(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval().to(dev)


def test_sam_decode_graphed_equals_eager_and_the_cpu(dev):
    """A 64-prompt decode (prep_mask.decode) recorded as a CUDA graph
    replays equal to the same decode eager, with 1 stream_init, 3
    token-to-image, 2 image-to-token and 2 residual-norm launches a decode;
    its logits and IoUs are the CPU's plain decode's to 1e-4 of the
    largest (the fp32 GEMMs and the upscaler on the card sum in other
    orders than the CPU's too)."""
    from gflow_tpu_torch.pipeline import prep_mask

    model = sam_decoder_model(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    emb = torch.randn(1, 256, 64, 64, generator=g, device=dev)
    pts = torch.rand(64, 2, generator=g, device=dev) * 1024
    with torch.inference_mode():
        graph_vs_eager(lambda: prep_mask.decode(model, emb, pts, dev),
                       launched=("sam_stream_init", "sam_t2i_attend", "sam_i2t_attend",
                                 "sam_residual_ln"))
        _build.LAUNCHES.clear()
        low, iou = prep_mask.decode(model, emb, pts, dev)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"sam_stream_init": 1, "sam_t2i_attend": 3,
                                         "sam_i2t_attend": 2, "sam_residual_ln": 2}
        cpu = model.to("cpu")
        want_low, want_iou = prep_mask.decode(cpu, emb.cpu(), pts[:8].cpu(), torch.device("cpu"))
    assert sam_rel(low[:8].cpu(), want_low) <= 1e-4 and sam_rel(iou[:8].cpu(), want_iou) <= 1e-4


@pytest.mark.parametrize("per_prompt_image", [True, False])
def test_sam_stream_init_per_prompt_image_or_dense_cells(dev, per_prompt_image):
    """SAM 2's shapes at 3 prompts over 64 x 64 x 256: a (3, C, h, w) image
    (a tracked frame's objects) with the (C,) dense prompt, or one image
    with a (3, C, h, w) dense prompt (the prompted frame's masks); one
    launch, bitwise the plain version."""
    from gflow_tpu_torch.ops import sam_decoder as sd

    g = torch.Generator(device=dev).manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    B = 3
    image = r(B if per_prompt_image else 1, 256, 64, 64)
    dense = r(256) if per_prompt_image else r(B, 256, 64, 64)
    pe = r(4096, 256)
    _build.LAUNCHES.clear()
    keys, kpe = sd.stream_init(image, dense, pe, B)
    want_keys, want_kpe = sd.stream_init_plain(image, dense, pe, B)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"sam_stream_init": 1}
    assert torch.equal(keys, want_keys) and torch.equal(kpe, want_kpe)


def sam2_small(dev, seed=0):
    """SAM 2 with its released decoder, memory and neck widths (256, memory
    64: the decoder kernels' widths) on a 2-block 16-wide Hiera at a 256
    input (a 16 x 16 embedding), a bank of 3 memories and 4 pointers."""
    from gflow_tpu_torch.models.random_weights import seeded_state_dict
    from gflow_tpu_torch.models.sam2 import Sam2Config, Sam2Model, convert

    cfg = Sam2Config(embed_dim=16, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
                     window_spec=(8, 4, 4, 2), image_size=256, num_maskmem=3,
                     max_obj_ptrs_in_encoder=4, memattn_layers=2)
    sd = seeded_state_dict(convert.expected_torch_keys(cfg), seed, 1.0)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(1.0)
    for k in sd:
        if k.endswith(".gamma"):
            sd[k].fill_(0.5)
    model = Sam2Model(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval().to(dev)


def test_sam2_propagation_graphed_equals_eager(dev, tmp_path):
    """prep_track.main over 7 frames of 3 objects with its parts as CUDA
    graphs against the same run eager: the written masks and every frame's
    memory and pointer 0 apart; the memory attention records one graph per
    fill of the bank (frames 1-4) and frames 4-6 replay one; the decoder's
    stream_init takes the per-cell dense prompt on frame 0 and per-object
    images after."""
    from PIL import Image

    from gflow_tpu_torch.models.sam2 import MemoryBank
    from gflow_tpu_torch.opt import graphs
    from gflow_tpu_torch.pipeline import prep_track

    seq = tmp_path / "seq"
    seq.mkdir()
    g = np.random.default_rng(3)
    for t in range(7):
        Image.fromarray(g.integers(0, 256, (96, 160, 3), dtype=np.uint8)).save(
            seq / f"{t:05d}.png")
    ann = np.zeros((96, 160), np.uint8)
    ann[10:50, 20:80], ann[40:90, 90:150], ann[60:80, 10:40] = 1, 2, 3
    img = Image.fromarray(ann, mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 0, 0, 128] + [0] * 756)
    img.save(tmp_path / "ann.png")
    model = sam2_small(dev)
    stored = []
    store = MemoryBank.store

    def record(self, t, memory, pointer):
        stored.append((memory.cpu(), pointer.cpu()))
        store(self, t, memory, pointer)

    caches = []

    def run():
        stored.clear()
        prep_track.TRACK_GRAPHS = graphs.ForwardCache("sam2", 32)
        caches.append(prep_track.TRACK_GRAPHS)
        out = prep_track.main(str(seq), annotation=str(tmp_path / "ann.png"), model=model)
        masks = [np.asarray(Image.open(f"{out}/{t:05d}.png")) for t in range(7)]
        return masks + [a for pair in stored for a in pair]

    orig, kept = MemoryBank.store, prep_track.TRACK_GRAPHS
    MemoryBank.store = record
    try:
        replays = graph_vs_eager(run, launched=("sam_stream_init", "sam_t2i_attend"))
    finally:
        MemoryBank.store, prep_track.TRACK_GRAPHS = orig, kept
    assert replays["sam2"] == 7 + 1 + 6 + 6 + 7
    # the graphed run's cache (the eager run's records none)
    assert len([k for k in caches[0].entries if "memattn" in k[0]]) == 4
