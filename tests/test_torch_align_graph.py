"""The global alignment's Adam loop as CUDA graphs
(gflow_tpu_torch.models.mast3r.alignment._refine), on the CPU: a fake
capture (test_torch_stage_graph.FakeGraph) stands in for the card, so the
fixed buffers, the on-device lr and bias corrections, the chunks of
CHUNK steps and the cache keys run as on the card.

Tolerances: the on-device lr and bias corrections against
``cosine_decay`` and Python's arithmetic: none, exact; the graph runner
against the eager loop: none, exact (the same operations in the same
order); against the JAX package's jitted optax loop after 5 + 3 steps,
poses and depths 1e-6, the final loss 1e-5 relative, as
tests/test_torch_alignment.py holds the eager loop."""
import numpy as np
import pytest
import torch

from gflow_tpu.models.mast3r import alignment as jalign
from gflow_tpu_torch.models.mast3r import alignment
from gflow_tpu_torch.opt import graphs
from test_torch_alignment import assert_close
from test_torch_stage_graph import FakeGraph
from tests.test_mast3r import _edge_preds_from_scene, _make_scene_pointmaps
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture
def fake(monkeypatch):
    """The card's graph path on the CPU: graphs on outside
    disable_graphs(), the refinement's cache recording with FakeGraph.
    Yields that cache."""
    monkeypatch.setattr(graphs, "graphed", lambda dev: not graphs._eager)
    cache = graphs.GraphCache(maxsize=8, capture=FakeGraph)
    monkeypatch.setattr(alignment, "REFINE_GRAPHS", cache)
    FakeGraph.captures = 0
    graphs.REPLAYS.clear()
    yield cache


@pytest.fixture(scope="module")
def scene():
    canon, poses, hw = _make_scene_pointmaps(n_frames=4)
    return _edge_preds_from_scene(canon, poses, noise=0.01, seed=1), len(poses), hw


def refine_inputs(T=4, E=6, S=64, seed=0):
    """Seeded refinement inputs: near-identity poses, log-scales, edges
    between random frames, and points seen from two frames with noise."""
    rng = np.random.default_rng(seed)
    q = np.c_[rng.normal(0, 0.02, (T, 3)), np.ones(T)]
    poses = np.c_[q / np.linalg.norm(q, axis=1, keepdims=True), rng.normal(0, 0.1, (T, 3))]
    ei, ej = rng.integers(0, T, E), (rng.integers(1, T, E) + np.arange(E)) % T
    src = rng.normal(0, 1, (E, S, 3)) + [0, 0, 3]
    dst = src + rng.normal(0, 0.05, src.shape)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)
    return (t(poses), t(rng.normal(0, 0.1, T)), t(ei, torch.int64), t(ej, torch.int64),
            t(src), t(dst), t(rng.uniform(0.5, 2.0, (E, S))))


@pytest.mark.parametrize("lr,steps", [(0.07, 500), (0.014, 200), (0.07, 23)])
def test_lr_and_bias_on_the_device_equal_the_host_arithmetic(lr, steps):
    """Every step of both stages and of a tail the chunk does not divide:
    -cosine_decay(lr, steps, t) and 1 - b ** (t + 1), computed in Python
    and rounded to float32, equal lr_and_bias's tensors exactly."""
    lr = float(np.float32(lr))
    lr_t = torch.tensor(lr, dtype=torch.float64)
    steps_t = torch.tensor(float(steps), dtype=torch.float64)
    for t in range(steps + 2):
        got = alignment.lr_and_bias(torch.tensor(t), lr_t, steps_t)
        want = (np.float32(-alignment.cosine_decay(lr, steps, t)),
                np.float32(1.0 - 0.9 ** (t + 1)), np.float32(1.0 - 0.999 ** (t + 1)))
        assert [g.dtype for g in got] == [torch.float32] * 3
        assert [float(g) for g in got] == [float(w) for w in want], t


def test_graph_runner_refine_equals_eager(fake):
    """20 steps (one chunk) replayed through the graph runner equal the
    eager loop exactly; the chunk and the final loss each replay once."""
    args = refine_inputs()
    got = alignment._refine(*args, 0.07, 0.3, 20)
    with graphs.disable_graphs():
        want = alignment._refine(*args, 0.07, 0.3, 20)
    assert graphs.REPLAYS == {"adam20": 1, "loss": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], args[0])  # the steps moved the poses


def test_graph_runner_matches_jax(fake, scene):
    """global_align through the graph runner (5 + 3 steps: two tail graphs)
    against the JAX package's, as test_torch_alignment holds the eager
    loop."""
    preds, n, hw = scene
    got = alignment.global_align(preds, n, hw, n_sample=256, steps1=5, steps2=3, device="cpu")
    want = jalign.global_align(preds, n, hw, n_sample=256, steps1=5, steps2=3)
    assert graphs.REPLAYS == {"adam5": 1, "adam3": 1, "loss": 2}
    assert_close(got, want, 1e-6, 1e-6)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)


def test_one_graph_serves_both_stages(fake):
    """Both stages' lr and step counts are data: 40 steps at one lr and 20
    at another on the same (T, E, S) replay one chunk graph; the results
    equal eager. Another (T, E, S) makes another entry."""
    args = refine_inputs()
    got = [alignment._refine(*args, 0.07, 0.3, 40), alignment._refine(*args, 0.014, 0.3, 20)]
    with graphs.disable_graphs():
        want = [alignment._refine(*args, 0.07, 0.3, 40), alignment._refine(*args, 0.014, 0.3, 20)]
    assert len(fake.entries) == 1 and FakeGraph.captures == 2  # adam20 and loss
    assert graphs.REPLAYS == {"adam20": 3, "loss": 2}
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    for other in (refine_inputs(T=5), refine_inputs(E=7), refine_inputs(S=32)):
        alignment._refine(*other, 0.07, 0.3, 20)
    assert len(fake.entries) == 4
    (key,) = [k for k in fake.entries][:1]
    assert key[0] == ("refine", 4, 6, 64)
