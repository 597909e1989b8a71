"""Port parity: the LMedS fundamental matrix and Sampson error
(gflow_tpu_torch.ops.epipolar) and the epipolar error map
(gflow_tpu_torch.pipeline.prep_moveseg.epipolar_error_map) against the JAX
package's on the CPU. The port draws from a torch.Generator; here it is
handed JAX's draws (jax.random.split(PRNGKey) + randint, as
gflow_tpu/ops/epipolar.py makes them).

Eigenvector signs and the null vector's float32 noise differ between the
two eigensolvers, so F is not compared; the Sampson errors and masks are:
- Sampson errors atol 1e-9 + rtol 1e-3: an exact fit leaves float32 noise
  below 1e-9 in either package; outliers' errors (up to ~0.03) agree to
  ~5e-4 relative;
- inliers: the same on every point with a real residual (error > 1e-9);
  below that the threshold sits on each solver's own noise floor;
- error maps and masks: normalized maps within 1e-3, masks equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gflow_tpu.ops import epipolar as jepi
from gflow_tpu.pipeline.prep_moveseg import epipolar_error_map as jax_error_map
from gflow_tpu_torch.ops import epipolar
from gflow_tpu_torch.pipeline.prep_moveseg import epipolar_error_map, uv_grid
from tests.test_epipolar import synthetic_two_view
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


def jax_draws(N, seed=0, n_samples=512, n_score=8192):
    """The JAX LMedS's (idx, score_idx) for PRNGKey(seed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    idx = jax.random.randint(k1, (n_samples, 8), 0, N)
    score = jax.random.randint(k2, (min(n_score, N),), 0, N)
    return torch.from_numpy(np.array(idx)).long(), torch.from_numpy(np.array(score)).long()


def scene_flow(H, W, seed=0):
    """Forward flow (H, W, 2) of a rigid scene under a rotating and
    translating camera (smooth random depth: a unique F), with a block
    moving against it, and the block's slices (chip_smoke.py's, which
    tests do not import: it sets torch's TF32 flags on import)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    f, a = 0.9 * W, rng.uniform(1, 3, 4)
    Z = 3 + np.sin(a[0] * xx / W * 3 + a[1]) * np.cos(a[2] * yy / H * 3 + a[3])
    P = np.stack([(xx - W / 2) * Z / f, (yy - H / 2) * Z / f, Z], -1)
    th, ph = 0.03, 0.02
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(ph), -np.sin(ph)], [0, np.sin(ph), np.cos(ph)]])
    Q = P @ (Ry @ Rx).T + np.array([0.15, 0.05, 0.1])
    flow = np.stack([f * Q[..., 0] / Q[..., 2] + W / 2 - xx, f * Q[..., 1] / Q[..., 2] + H / 2 - yy],
                    -1)
    block = (slice(H // 3, H // 2), slice(W // 3, W // 2))
    flow[block] = (-6.0, 4.0)
    return flow.astype(np.float32), block


def test_sampson_error_matches_jax():
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.05, x1.shape)).astype(np.float32)
    F = rng.normal(size=(4, 3, 3)).astype(np.float32)
    got = epipolar.sampson_error(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(F))
    want = jepi.sampson_error(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("outlier_frac,seed", [(0.0, 0), (0.25, 1)])
def test_lmeds_with_jax_draws_matches_jax(outlier_frac, seed):
    x1, x2 = synthetic_two_view(outlier_frac=outlier_frac, seed=seed)
    F, inl = jepi.find_fundamental_lmeds(x1, x2, jax.random.PRNGKey(seed))
    want_err, want_inl = np.asarray(jepi.sampson_error(x1, x2, F)), np.asarray(inl)
    t1, t2 = torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(x2))
    G, got_inl = epipolar.find_fundamental_lmeds(t1, t2, draws=jax_draws(t1.shape[0], seed))
    got_err, got_inl = epipolar.sampson_error(t1, t2, G).numpy(), got_inl.numpy()
    np.testing.assert_allclose(got_err, want_err, atol=1e-9, rtol=1e-3)
    real = want_err > 1e-9
    np.testing.assert_array_equal(got_inl[real], want_inl[real])
    m = int(outlier_frac * len(got_inl))
    assert got_inl[m:].mean() > 0.85 and (m == 0 or got_inl[:m].mean() < 0.3)


def test_median_of_an_even_count_averages_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 9.0, 1.0, 1.0]])
    assert epipolar.median_last(x).tolist() == [2.5, 3.0]
    assert torch.median(x, -1).values.tolist() == [2.0, 1.0]  # the lower one
    assert epipolar.median_last(torch.tensor([3.0, 1.0, 2.0])).item() == 2.0
    errs = np.random.default_rng(1).exponential(size=(512, 8192)).astype(np.float32)
    np.testing.assert_array_equal(epipolar.median_last(torch.from_numpy(errs)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(errs), axis=-1)))


def test_error_map_matches_jax_and_flags_the_moving_block():
    H, W = 96, 128
    flow, block = scene_flow(H, W)
    want = jax_error_map(flow)
    got = epipolar_error_map(flow, device="cpu", draws=jax_draws(H * W))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got > 0.01, want > 0.01)
    # the port's own draws (torch.Generator, seed 0) find the same block
    own = epipolar_error_map(flow, device="cpu")
    np.testing.assert_array_equal(own > 0.01, want > 0.01)
    assert own[block].min() > 0.01
    assert (own > 0.01).mean() < 0.1


def test_error_map_on_translation_parallax():
    """tests/test_epipolar.py's flow (camera translation with row parallax,
    a block moving against it): the block's mean error exceeds 10x the
    background's, with the port's draws and with JAX's, as in the JAX
    package's. (The background's flow is affine in the row, so a plane of
    F fits it: which one each solver's float32 noise picks moves the
    block's errors, so the maps are compared on the rigid scene above.)"""
    H, W = 96, 128
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = 3.0 * np.linspace(0.8, 1.2, H)[:, None]
    flow[30:60, 40:80] = (-4.0, 2.5)
    for err in [jax_error_map(flow)] + [epipolar_error_map(flow, device="cpu", draws=d)
                                        for d in (None, jax_draws(H * W))]:
        outside = np.concatenate([err[:20].ravel(), err[70:].ravel()]).mean()
        assert err[35:55, 45:75].mean() > 10 * outside
    assert uv_grid(2, 4).tolist()[0][0] == [-0.75, -0.5]
