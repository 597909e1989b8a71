"""Port parity: projection + tile binning (gflow_tpu_torch.ops vs
gflow_tpu.ops), on the CPU, where binning packs with the plain gather.

Scenes use well-separated depths (a shuffled ladder with jitter) so no two
Gaussians share a packed (tile, depth-bits) sort key: the two sorts are
free to order tied keys differently (gflow_tpu/ops/binning.py:201), and
without ties the lists must be EQUAL.

Tolerances: projection is f32 elementwise math in the same order in both
packages; uv/depth/conic agree to 1e-4 relative. radius = ceil(3 sqrt(lam))
can flip by one pixel where 3 sqrt(lam) sits within rounding of an
integer, so radius is checked to agree on all but a handful of points and
by at most 1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core.camera import default_intrinsics
from gflow_tpu.ops import binning as jbin
from gflow_tpu.ops.projection import compute_cov3d as j_cov3d
from gflow_tpu.ops.projection import project_gaussians as j_project
from gflow_tpu.ops.projection import supported_max_radius as j_smr
from gflow_tpu_torch.ops import binning as tbin
from gflow_tpu_torch.ops.projection import compute_cov3d as t_cov3d
from gflow_tpu_torch.ops.projection import project_gaussians as t_project
from gflow_tpu_torch.ops.projection import supported_max_radius as t_smr


def scene(n, seed, spread=1.0, scale_hi=0.15):
    rng = np.random.default_rng(seed)
    z = 2.0 + 4.0 * (rng.permutation(n) + rng.uniform(0.1, 0.9, n)) / n
    xyz = np.c_[rng.uniform(-spread, spread, (n, 2)) * z[:, None] / 2, z]
    xyz[: n // 20, 2] *= -1.0           # behind the camera
    xyz[n // 20: n // 10, 0] *= 4.0     # mostly off-screen
    scale = rng.uniform(0.01, scale_hi, (n, 3))
    rotate = rng.normal(size=(n, 4))
    return [np.asarray(a, np.float32) for a in (xyz, scale, rotate)]


def both_projections(W, H, n=512, seed=0, max_radius=None, **kw):
    xyz, scale, rotate = scene(n, seed, **kw)
    intr = np.array(default_intrinsics(W, H))
    extr = np.c_[np.eye(3), [0.05, -0.02, 0.1]].astype(np.float32)
    pj = j_project(*(jnp.asarray(a) for a in (xyz, scale, rotate, intr, extr)), W, H,
                   max_radius=max_radius)
    pt = t_project(*(torch.from_numpy(a) for a in (xyz, scale, rotate, intr, extr)), W, H,
                   max_radius=max_radius)
    return pj, pt


@pytest.mark.parametrize("max_radius", [None, 8.0, 24.0])
def test_projection_matches_jax(max_radius):
    W, H = 150, 90
    pj, pt = both_projections(W, H, n=600, seed=1, max_radius=max_radius, scale_hi=0.4)
    vis = np.asarray(pj["visible"])
    assert 100 < vis.sum() < len(vis)  # some points culled
    np.testing.assert_array_equal(pt["visible"].numpy(), vis)
    for k in ("uv", "depth", "conic"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-4, atol=1e-4)
    r_t, r_j = pt["radius"].numpy(), np.asarray(pj["radius"])
    assert np.abs(r_t - r_j).max() <= 1.0
    differ = r_t != r_j
    if max_radius is None:
        assert differ.sum() <= 3
    else:
        # the shrink puts clamped splats at 3 sqrt(lam) == max_radius to
        # rounding, exactly where ceil flips
        assert (np.minimum(r_t, r_j)[differ] == max_radius).all()


def test_cov3d_and_supported_radius_match_jax():
    _, scale, rotate = scene(64, 2)
    np.testing.assert_allclose(
        t_cov3d(torch.from_numpy(scale), torch.from_numpy(rotate)).numpy(),
        np.asarray(j_cov3d(jnp.asarray(scale), jnp.asarray(rotate))), rtol=1e-5, atol=1e-8)
    for m in (4, 8, 12, 16, 32, 48, 64, 96):
        assert t_smr(m) == j_smr(m)
        assert tbin._rect_grid_dims(m) == jbin._rect_grid_dims(m)


@pytest.mark.parametrize("W,H,m,small,K", [
    (64, 48, 32, 0, 128),     # single class
    (150, 90, 16, 0, 64),     # odd size, tile padding
    (150, 90, 48, 8, 96),     # two-class emission
    (160, 96, 64, 8, 32),     # two-class, K overflow
])
def test_binning_equal_to_jax(W, H, m, small, K):
    """tile_counts and tile_lists EQUAL to the JAX package's, from the same
    projected inputs (the JAX projection's uv/depth/radius feed both). About
    35 splats are classed large, under the cap of 88, so the choice among
    equal-area splats at the cap (test below) does not arise."""
    pj, _ = both_projections(W, H, n=700, seed=3, scale_hi=0.15)
    uv, depth, radius = (np.asarray(pj[k]) for k in ("uv", "depth", "radius"))
    kw = dict(max_per_tile=K, max_tiles_per_gaussian=m, small_tiles_per_gaussian=small)
    bj = jbin.bin_gaussians(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(radius), W, H, **kw)
    bt = tbin.bin_gaussians(torch.from_numpy(uv), torch.from_numpy(depth),
                            torch.from_numpy(radius), W, H, **kw)
    np.testing.assert_array_equal(bt.tile_counts.numpy(), np.asarray(bj.tile_counts))
    np.testing.assert_array_equal(bt.tile_lists.numpy(), np.asarray(bj.tile_lists))
    assert int(bt.large_clamped) == int(bj.large_clamped)
    assert (bt.tile_counts > 0).sum() > 0
    if K == 32:
        assert (bt.tile_counts > K).any()  # the overflow case really overflows


def test_two_class_cap_clamps_like_jax():
    """More large splats than the large_frac cap: the smallest large splats
    fall back to the small grid, counted in large_clamped. Areas are made
    distinct (radius ladder) so both packages select the same splats."""
    W, H, n = 160, 96, 64
    rng = np.random.default_rng(5)
    uv = np.c_[rng.uniform(10, W - 10, n), rng.uniform(10, H - 10, n)].astype(np.float32)
    depth = (2.0 + 0.05 * rng.permutation(n) + 0.01)[:, None].astype(np.float32)
    radius = np.linspace(2.0, 40.0, n).astype(np.float32)
    kw = dict(max_per_tile=64, max_tiles_per_gaussian=48, small_tiles_per_gaussian=8,
              large_frac=0.125)
    bj = jbin.bin_gaussians(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(radius), W, H, **kw)
    bt = tbin.bin_gaussians(torch.from_numpy(uv), torch.from_numpy(depth),
                            torch.from_numpy(radius), W, H, **kw)
    assert int(bj.large_clamped) > 0
    assert int(bt.large_clamped) == int(bj.large_clamped)
    np.testing.assert_array_equal(bt.tile_counts.numpy(), np.asarray(bj.tile_counts))
    np.testing.assert_array_equal(bt.tile_lists.numpy(), np.asarray(bj.tile_lists))


def test_pack_tile_lists_cpu_is_the_masked_gather():
    """On CPU tensors the K4 wrapper is the plain gather of
    gflow_tpu/ops/binning.py:229-234, including the -1 fill and K cap."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 12, 20).astype(np.int32)
    starts = np.r_[0, np.cumsum(counts)[:-1]].astype(np.int32)
    idx_s = rng.permutation(int(counts.sum()) + 5).astype(np.int32)
    got = tbin.pack_tile_lists(torch.from_numpy(idx_s), torch.from_numpy(starts),
                               torch.from_numpy(counts), 8).numpy()
    for t in range(20):
        c = min(counts[t], 8)
        np.testing.assert_array_equal(got[t, :c], idx_s[starts[t]:starts[t] + c])
        assert (got[t, c:] == -1).all()
