"""The LMedS as a CUDA graph (gflow_tpu_torch.ops.epipolar's
find_fundamental_lmeds through ``LMEDS_GRAPHS``) and the small
eigensolver's formulation of _solve_f, on the CPU: a fake capture
(test_torch_stage_graph.FakeGraph) stands in for the card, and the
eigenvectors come from the kernel's plain version (torch.linalg.eigh).

Tolerances: the rank-2 projection F (I - v v^T) against the SVD form U
diag(s1, s2, 0) V^T: 1e-6 on unit-norm F, in float64 (in float32 the two
factorizations round 1e-6 apart where s2 and s3 of a minimal sample's F
lie close); the graph runner against the eager LMedS: none, exact;
against the JAX package with JAX's draws, as tests/test_torch_epipolar.py
holds the eager LMedS: Sampson errors atol 1e-9 + rtol 1e-3, inliers
equal wherever the residual is real (> 1e-9)."""
import jax
import numpy as np
import pytest
import torch

from gflow_tpu.ops import epipolar as jepi
from gflow_tpu_torch.ops import epipolar
from gflow_tpu_torch.opt import graphs
from test_torch_epipolar import jax_draws
from test_torch_stage_graph import FakeGraph
from tests.test_epipolar import synthetic_two_view
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture
def fake(monkeypatch):
    """The card's graph path on the CPU: graphs on outside
    disable_graphs(), the LMedS's cache recording with FakeGraph."""
    monkeypatch.setattr(graphs, "graphed", lambda dev: not graphs._eager)
    cache = graphs.ForwardCache("lmeds", 8, capture=FakeGraph)
    monkeypatch.setattr(epipolar, "LMEDS_GRAPHS", cache)
    FakeGraph.captures = 0
    graphs.REPLAYS.clear()
    yield cache


def test_rank2_projection_equals_the_svd_form():
    """On seeded F and on the minimal samples' null vectors (unit
    Frobenius norm): F - (F v) v^T, v the smallest eigenvector of F^T F,
    equals U diag(s1, s2, 0) V^T; _solve_f computes exactly that."""
    rng = np.random.default_rng(0)
    x1, x2 = synthetic_two_view(outlier_frac=0.25, seed=1)
    x1, x2 = torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(x2))
    idx = torch.from_numpy(rng.integers(0, x1.shape[0], (256, 8)))
    A = epipolar._design_rows(x1[idx], x2[idx])
    null = epipolar.smallest_eigvec(A.transpose(-1, -2) @ A).reshape(-1, 3, 3)
    F = torch.cat([null.double(), torch.from_numpy(rng.normal(size=(256, 3, 3)))])
    F = F / torch.linalg.matrix_norm(F)[:, None, None]
    v = epipolar.smallest_eigvec(F.transpose(-1, -2) @ F)[..., None]
    got = F - (F @ v) @ v.transpose(-1, -2)
    U, S, Vh = torch.linalg.svd(F)
    want = U @ (torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], -1)[..., None] * Vh)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # _solve_f is that projection of the null vectors, in float32
    F32 = null
    v = epipolar.smallest_eigvec(F32.transpose(-1, -2) @ F32)[..., None]
    assert torch.equal(epipolar._solve_f(A), F32 - (F32 @ v) @ v.transpose(-1, -2))


def test_small_eig_needs_the_card():
    """The kernel's wrapper takes no CPU tensor (the CPU takes the plain
    version through smallest_eigvec) and refuses what it cannot solve."""
    M = torch.eye(3).expand(4, 3, 3).contiguous()
    with pytest.raises(ValueError, match="CUDA device"):
        epipolar.small_eig(M)
    for bad in (M.double(), torch.eye(10)[None], torch.ones(4, 3, 2)):
        with pytest.raises(ValueError, match="small_eig"):
            epipolar.small_eig(bad)
    torch.testing.assert_close(epipolar.smallest_eigvec(torch.diag(torch.tensor([3.0, 1.0, 2.0]))),
                               torch.tensor([0.0, 1.0, 0.0]))


@pytest.mark.parametrize("outlier_frac,seed", [(0.0, 0), (0.25, 1)])
def test_graphed_lmeds_equals_eager_and_matches_jax(fake, outlier_frac, seed):
    """Through the graph runner with JAX's draws: F and the inliers equal
    the eager LMedS exactly (one graph, one replay), and the Sampson
    errors and the inliers match the JAX package's."""
    x1, x2 = synthetic_two_view(outlier_frac=outlier_frac, seed=seed)
    F, inl = jepi.find_fundamental_lmeds(x1, x2, jax.random.PRNGKey(seed))
    want_err, want_inl = np.asarray(jepi.sampson_error(x1, x2, F)), np.asarray(inl)
    t1, t2 = torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(x2))
    draws = jax_draws(t1.shape[0], seed)
    G, got_inl = epipolar.find_fundamental_lmeds(t1, t2, draws=draws)
    with graphs.disable_graphs():
        G_eager, inl_eager = epipolar.find_fundamental_lmeds(t1, t2, draws=draws)
    assert torch.equal(G, G_eager) and torch.equal(got_inl, inl_eager)
    assert graphs.REPLAYS == {"lmeds": 1} and FakeGraph.captures == 1
    got_err, got_inl = epipolar.sampson_error(t1, t2, G).numpy(), got_inl.numpy()
    np.testing.assert_allclose(got_err, want_err, atol=1e-9, rtol=1e-3)
    real = want_err > 1e-9
    np.testing.assert_array_equal(got_inl[real], want_inl[real])


def test_lmeds_key_is_the_shapes_not_the_draws(fake):
    """Other draws of the same counts replay the same graph (the draws are
    data, copied into its buffers); another point count or sample count
    records another."""
    x1, x2 = synthetic_two_view(outlier_frac=0.25, seed=1)
    t1, t2 = torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(x2))
    N = t1.shape[0]
    outs = [epipolar.find_fundamental_lmeds(t1, t2, draws=jax_draws(N, s)) for s in (0, 1)]
    assert len(fake.entries) == 1 and graphs.REPLAYS == {"lmeds": 2}
    assert not torch.equal(outs[0][1], outs[1][1]) or not torch.equal(outs[0][0], outs[1][0])
    epipolar.find_fundamental_lmeds(t1, t2, draws=jax_draws(N, 0, n_samples=64))
    epipolar.find_fundamental_lmeds(t1[:-8], t2[:-8], draws=jax_draws(N - 8, 0))
    assert len(fake.entries) == 3
