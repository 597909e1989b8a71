"""The prep models' forwards as CUDA graphs (prep_flow's GMFlow and
prep_depth's MASt3R through ``opt.graphs.module_call``, and
``parallel.mesh.sharded_batch_apply``'s replicas), on the CPU: a fake
capture (test_torch_stage_graph.FakeGraph) stands in for the card, so the
cache keys, the loading of inputs and the cloning of outputs run as on the
card; then the same forwards against the JAX package's ``model.apply``.

Tolerances: the graph runner against the eager forward: none, exact (the
same operations in the same order). Against the JAX package, as the
parity tests hold the eager models: GMFlow's flow atol 5e-4 / rtol 1e-3
(tests/test_torch_gmflow.py), MASt3R's outputs atol 2e-4 / rtol 1e-3
(tests/test_torch_mast3r.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.models.mast3r import vit as jvit
from gflow_tpu.models.unimatch import gmflow as jg
from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel
from gflow_tpu_torch.opt import graphs
from gflow_tpu_torch.parallel.mesh import make_mesh, sharded_batch_apply
from gflow_tpu_torch.pipeline import prep_depth, prep_flow
from test_torch_stage_graph import FakeGraph
from tests import test_torch_gmflow as tg
from tests import test_torch_mast3r as tm
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture
def fake(monkeypatch):
    """The card's graph path on the CPU: graphs on outside
    disable_graphs(), the prep caches recording with FakeGraph. Yields
    {name: cache}."""
    monkeypatch.setattr(graphs, "graphed", lambda dev: not graphs._eager)
    caches = {}
    for module, attr in ((prep_flow, "FLOW_GRAPHS"), (prep_depth, "DEPTH_GRAPHS")):
        caches[attr] = graphs.ForwardCache(getattr(module, attr).name, 8, capture=FakeGraph)
        monkeypatch.setattr(module, attr, caches[attr])
    FakeGraph.captures = 0
    graphs.REPLAYS.clear()
    yield caches


@pytest.fixture(scope="module")
def gmflow_case():
    """GMFlow's small config, its weights, two pairs and the JAX model's
    flow on the first."""
    sd = tg.small_state_dict()
    a, b = tg.images()
    c, d = tg.images(seed=5)
    want = jg.GMFlow(jg.GMFlowConfig(**tg.SMALL)).apply(tg.jax_params(sd), jnp.asarray(a),
                                                        jnp.asarray(b))
    return sd, [(a, b), (c, d)], np.asarray(want)


def flow_runner(model, cache):
    return prep_flow.batch_runner(model, 0, torch.device("cpu"), cache)[0]


def test_gmflow_graph_runner_equals_eager_and_jax(fake, gmflow_case):
    """Two pairs of one shape through the graph runner: one graph, two
    replays, each flow equal to the eager forward and within the parity
    test's tolerance of the JAX model's."""
    sd, pairs, want = gmflow_case
    model = tg.port_model(sd)
    run = flow_runner(model, fake["FLOW_GRAPHS"])
    outs = []
    with torch.inference_mode():
        for a, b in pairs:
            a, b = torch.from_numpy(a), torch.from_numpy(b)
            outs.append(run(a, b))
            assert torch.equal(outs[-1], model(a, b))
        again = run(*(torch.from_numpy(x) for x in pairs[0]))
    assert len(fake["FLOW_GRAPHS"].entries) == 1 and FakeGraph.captures == 1
    assert graphs.REPLAYS == {"gmflow": 3}
    # each call's outputs are its own: the last replay left the second's
    assert torch.equal(again, outs[0]) and not torch.equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[0].numpy(), want, atol=tg.ATOL, rtol=tg.RTOL)


def test_reloaded_model_records_anew(fake, gmflow_case):
    """A model whose weights are loaded into new tensors (assign=True, as a
    move to another device gives new storage) gets a graph of its own, and
    its flow is the new weights' own; one loaded into its own tensors
    replays the same graph with the new values."""
    sd, pairs, _ = gmflow_case
    model = tg.port_model(sd)
    run = flow_runner(model, fake["FLOW_GRAPHS"])
    a, b = (torch.from_numpy(x) for x in pairs[0])
    other = tg.small_state_dict(seed=3)
    with torch.inference_mode():
        first = run(a, b)
        model.load_state_dict(other, assign=True)
        second = run(a, b)
        assert torch.equal(second, model(a, b)) and not torch.equal(first, second)
        assert len(fake["FLOW_GRAPHS"].entries) == 2
        model.load_state_dict(sd)  # copied into the assigned tensors
        assert torch.equal(run(a, b), first)
    assert len(fake["FLOW_GRAPHS"].entries) == 2 and graphs.REPLAYS == {"gmflow": 3}


def test_mast3r_graph_runner_equals_eager_and_jax(fake):
    cfg, sd, params, _ = tm.small_case("catmlp+dpt", True)
    model = Mast3rModel(Mast3rConfig(**cfg)).eval()
    model.load_state_dict(sd, strict=True)
    run = prep_flow.batch_runner(model, 0, torch.device("cpu"), fake["DEPTH_GRAPHS"])[0]
    a, b = tm.views()
    c, d = tm.views(seed=4)
    with torch.inference_mode():
        got = run(torch.from_numpy(a), torch.from_numpy(b))
        run(torch.from_numpy(c), torch.from_numpy(d))
        eager = model(torch.from_numpy(a), torch.from_numpy(b))
    assert graphs.REPLAYS == {"mast3r": 2} and FakeGraph.captures == 1
    want = jvit.Mast3rModel(jvit.Mast3rConfig(**cfg)).apply(params, jnp.asarray(a),
                                                           jnp.asarray(b))
    for g, e, w in zip(got, eager, want):
        assert set(g) == set(e) == set(w)
        for k in w:
            assert torch.equal(g[k], e[k])
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=tm.ATOL,
                                       rtol=tm.RTOL)


def test_sharded_batch_apply_through_graphs_matches_one_replica(fake, gmflow_case):
    """Two CPU "devices" on the data axis: each half of the batch goes
    through the cache (one entry: both replicas are the CPU's model) and
    equals the model on that half; a batch of 4 replays twice."""
    sd, pairs, _ = gmflow_case
    model = tg.port_model(sd)
    run = sharded_batch_apply(model, make_mesh(2, data_parallel=2, device="cpu"),
                              fake["FLOW_GRAPHS"])
    a = torch.from_numpy(np.concatenate([p[0] for p in pairs] * 2))
    b = torch.from_numpy(np.concatenate([p[1] for p in pairs] * 2))
    with torch.inference_mode():
        got = run(a, b)
        want = torch.cat([model(a[i:i + 2], b[i:i + 2]) for i in (0, 2)])
    assert torch.equal(got, want)
    assert graphs.REPLAYS == {"gmflow": 2} and len(fake["FLOW_GRAPHS"].entries) == 1
