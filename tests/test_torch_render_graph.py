"""The host-called renders and projections as CUDA graphs (ops.render's
render_jit, render_traj_jit and render2img; the trainer's diagnostic,
trajectory and projection calls), on the CPU: a fake capture
(test_torch_stage_graph.FakeGraph) stands in for the card, so the cache
keys, their bounds, the loading of inputs and the cloning of outputs run
as on the card; then the same calls against the JAX package's
render_jit / render_traj_jit / _compiled_diag / _compiled_gather_project,
with the Pallas kernels in interpret mode as tests/test_pallas.py runs
them on the CPU.

Tolerances: the graph runner against the eager call: none, every
comparison is exact (the same operations in the same order). Against the
JAX package, as tests/test_torch_render.py holds the render: float images
atol 1e-4 / rtol 1e-5 (the same sums in another order); uint8 images
within one level, the turbo depth colormap (a 256-bin lookup, a depth on
a bin edge may land one bin over) on all but 0.5% of pixels; projected uv
atol 1e-4, gathered xyz exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core import camera as jcam
from gflow_tpu.ops.render import RenderConfig as JConfig
from gflow_tpu.ops.render import render_jit as j_render_jit
from gflow_tpu.ops.render import render_traj_jit as j_render_traj_jit
from gflow_tpu.opt.state import Params as JParams
from gflow_tpu.opt.state import init_frame_state as j_init_frame_state
from gflow_tpu.pipeline import trainer as jtrainer
from gflow_tpu_torch.core.scene import activate_inv
from gflow_tpu_torch.ops import render as trender
from gflow_tpu_torch.ops.render import RenderConfig as TConfig
from gflow_tpu_torch.opt import graphs
from gflow_tpu_torch.opt.graphs import ForwardCache
from gflow_tpu_torch.opt.state import Params, init_frame_state
from gflow_tpu_torch.pipeline import trainer as ttrainer
from test_torch_render import traj_line_set
from test_torch_stage_graph import FakeGraph

W, H, N, CAP = 96, 64, 400, 512
CFG = dict(max_per_tile=64, max_tiles_per_gaussian=16)
OUTS = ("rgb", "uv", "depth", "depth_map", "acc", "center")


@pytest.fixture
def fake(monkeypatch):
    """The card's graph path on the CPU: graphs on, every forward cache
    recording with FakeGraph. Yields the render module's fresh caches."""
    monkeypatch.setattr(graphs, "graphed", lambda dev: True)
    caches = {}
    for attr, size in (("RENDER_GRAPHS", 64), ("RENDER_TRAJ_GRAPHS", 32),
                       ("QUANTIZE_GRAPHS", 64)):
        caches[attr] = ForwardCache(getattr(trender, attr).name, size, capture=FakeGraph)
        monkeypatch.setattr(trender, attr, caches[attr])
    FakeGraph.captures = 0
    graphs.REPLAYS.clear()
    yield caches


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("GFLOW_PALLAS_INTERPRET", "1")


def scene(n=N, cap=CAP, seed=0):
    """Activated arrays padded to `cap` (dead slots at opacity 0), untied
    depths as in tests/synth.py's ripple, intrinsics and a camera."""
    rng = np.random.default_rng(seed)
    z = 2.0 + 3.0 * (rng.permutation(n) + rng.uniform(0.1, 0.9, n)) / n
    pad = lambda a, fill=0.0: np.concatenate(
        [a, np.full((cap - n,) + a.shape[1:], fill, np.float32)]).astype(np.float32)
    xyz = pad(np.c_[rng.uniform(-1, 1, (n, 2)) * z[:, None] / 2.5, z])
    scale = pad(rng.uniform(0.02, 0.12, (n, 3)), 1e-8)
    rotate = rng.normal(size=(n, 4))
    rotate = pad(rotate / np.linalg.norm(rotate, axis=1, keepdims=True), 0.5)
    opacity = pad(rng.uniform(0.3, 0.95, (n, 1)))
    rgb = pad(rng.uniform(0.05, 0.95, (n, 3)))
    intr = np.asarray(jcam.default_intrinsics(W, H), np.float32)
    return xyz, scale, rotate, opacity, rgb, intr


def extr_of(shift):
    return np.c_[np.eye(3), [shift, -0.01, 0.0]].astype(np.float32)


def tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_render_jit_key_excludes_the_data(fake):
    """One graph serves every camera and every frame of one capacity: the
    tensors are loaded into its buffers. Capacity, config, bg, outputs and
    as_uint8 each make another entry. Each call equals the eager render."""
    cache = fake["RENDER_GRAPHS"]
    args = tensors(*scene())
    other = tensors(*scene(seed=1))  # another frame of the same capacity
    for arrays, shift in ((args, 0.02), (args, -0.05), (other, 0.0)):
        extr = extr_of(shift)
        got = trender.render_jit(*arrays, extr, 0.1, W, H, OUTS, TConfig(**CFG), device="cpu")
        want = trender.render(*arrays, extr, 0.1, W, H, OUTS, TConfig(**CFG), device="cpu")
        assert equal(got, want)
    assert len(cache.entries) == 1 and FakeGraph.captures == 1
    assert graphs.REPLAYS == {"render": 3}
    bigger = tensors(*scene(cap=1024))
    variants = [(bigger, 0.1, OUTS, TConfig(**CFG), False),
                (args, 0.1, OUTS, TConfig(max_per_tile=96, max_tiles_per_gaussian=16), False),
                (args, 0.3, OUTS, TConfig(**CFG), False),
                (args, 0.1, ("rgb",), TConfig(**CFG), False),
                (args, 0.1, OUTS, TConfig(**CFG), True)]
    for arrays, bg, outs, cfg, u8 in variants:
        trender.render_jit(*arrays, extr_of(0.0), bg, W, H, outs, cfg, as_uint8=u8,
                           device="cpu")
    assert len(cache.entries) == 1 + len(variants)


def test_outputs_are_cloned_before_the_next_replay(fake):
    args = tensors(*scene())
    first = trender.render_jit(*args, extr_of(0.02), 0.0, W, H, ("rgb",), TConfig(**CFG),
                               device="cpu")["rgb"]
    kept = first.clone()
    second = trender.render_jit(*args, extr_of(-0.08), 0.0, W, H, ("rgb",), TConfig(**CFG),
                                device="cpu")["rgb"]
    assert torch.equal(first, kept) and not torch.equal(first, second)
    img = trender.render2img(first)
    assert graphs.REPLAYS == {"render": 2, "quantize": 1}
    np.testing.assert_array_equal(img, (kept.clamp(0, 1) * 255).to(torch.uint8).numpy())


def test_render_traj_jit_one_graph_for_every_count(fake):
    """n_actual is data: the graph recorded at one count, replayed at
    another, equals the eager render_traj at each."""
    arrays = tensors(*traj_line_set(300, 512, W=W, H=H))
    cfg = TConfig(max_per_tile=128, max_tiles_per_gaussian=8)
    for n_actual in (300, 120):
        got = trender.render_traj_jit(*arrays, 0.0, W, H, 16, 0.5, 2.0, cfg, n_actual=n_actual,
                                      device="cpu")
        want = trender.render_traj(*arrays, 0.0, W, H, 16, 0.5, 2.0, cfg, n_actual=n_actual,
                                   device="cpu")
        assert torch.equal(got, want)
    assert len(fake["RENDER_TRAJ_GRAPHS"].entries) == 1 and FakeGraph.captures == 1
    u8 = trender.render_traj_jit(*arrays, 0.0, W, H, 16, 0.5, 2.0, cfg, n_actual=120,
                                 as_uint8=True, device="cpu")
    assert torch.equal(u8, trender.quantize_u8(want))
    assert len(fake["RENDER_TRAJ_GRAPHS"].entries) == 2


@pytest.mark.parametrize("maxsize", [1, 4])
def test_forward_cache_keeps_the_most_recent(maxsize):
    cache = ForwardCache("f", maxsize, capture=FakeGraph)
    keys = list(range(maxsize + 1))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(graphs, "graphed", lambda dev: True)
        for k in keys:
            cache(k, lambda x: x + 1, {"x": torch.zeros(3)}, torch.device("cpu"))
        cache(keys[-1], lambda x: x + 1, {"x": torch.zeros(3)}, torch.device("cpu"))
    assert len(cache.entries) == maxsize
    assert keys[0] not in {k[0] for k in cache.entries} and keys[-1] in {k[0] for k in cache.entries}


def test_cache_bounds_follow_the_jax_package():
    """64 / 32 render and trajectory renders (gflow_tpu/ops/render.py:136,
    :328), 16 / 4 / 1 / 1 the trainer's diagnostic, trajectory, world2pix
    and gather-project calls (gflow_tpu/pipeline/trainer.py:61-113)."""
    assert trender.RENDER_GRAPHS.maxsize == 64 and trender.RENDER_TRAJ_GRAPHS.maxsize == 32
    tr = ttrainer.GFlowTrainer(np.zeros((H, W, 3), np.float32), make_logs=False, device="cpu")
    assert {k: c.maxsize for k, c in tr.forward_graphs.items()} == {
        "diag": 16, "traj": 4, "world2pix": 1, "gather_project": 1}
    assert {k: c.maxsize for k, c in tr.forward_graphs.items()} == {
        "diag": jtrainer._compiled_diag.cache_info().maxsize,
        "traj": jtrainer._compiled_traj_render.cache_info().maxsize,
        "world2pix": jtrainer._compiled_world2pix.cache_info().maxsize,
        "gather_project": jtrainer._compiled_gather_project.cache_info().maxsize}


def trainer_with(fake_graphs):
    """A CPU trainer on scene()'s points, its caches recording with
    FakeGraph when fake_graphs, and a trajectory line set of two frames."""
    xyz, scale, rotate, opacity, rgb, intr = scene()
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    tr = ttrainer.GFlowTrainer(img, num_points=N, capacity=CAP, make_logs=False,
                               render_config=TConfig(**CFG), device="cpu")
    t = lambda a: torch.from_numpy(a)
    tr.params = Params(t(xyz), t(scale), t(rotate),
                       activate_inv("opacity", t(opacity).clamp_min(1e-6)),
                       activate_inv("rgb", t(rgb)), tr.params.pose, tr.params.depth_ab)
    still = torch.from_numpy(rng.uniform(size=CAP) < 0.6)
    tr.state = init_frame_state(CAP, "cpu")._replace(
        n_alive=torch.tensor(N, dtype=torch.int32), last_num=torch.tensor(N - 50, dtype=torch.int32),
        still_mask=still)
    tr.load_camera(extr=extr_of(0.02))
    if fake_graphs:
        tr.forward_graphs = {k: ForwardCache(k, c.maxsize, capture=FakeGraph)
                             for k, c in tr.forward_graphs.items()}
    return tr


def trainer_calls(tr):
    """The trainer's graphed calls: diag views, two frames of trajectory
    eval (gather_project, traj render) and project_points."""
    out = {"diag": tr._diag_views()}
    query = np.arange(0, N, 25)
    for frame, shift in enumerate((0.02, -0.03)):
        tr.load_camera(extr=extr_of(shift))
        res = tr.eval(query, need_center_depth=False, return_query_uv=True)
        out[f"traj{frame}"], out[f"uv{frame}"] = res[3], res[5]
    out["project"] = tr.project_points(tr.params.xyz[:60].numpy())
    return out


def test_trainer_graphs_equal_eager_and_key_on_capacity_and_config(monkeypatch, fake):
    with monkeypatch.context() as m:
        m.setattr(graphs, "graphed", lambda dev: False)
        eager = trainer_calls(trainer_with(False))
    graphs.REPLAYS.clear()
    tr = trainer_with(True)
    got = trainer_calls(tr)
    for k, want in eager.items():
        for a, b in zip(*(v.values() if isinstance(v, dict) else v if isinstance(v, tuple)
                          else (v,) for v in (want, got[k]))):
            np.testing.assert_array_equal(a, b, err_msg=k)
    # two frames' traj renders through one graph; render_views of the eval
    # goes to ops.render's own cache, not the trainer's
    assert {k: len(c.entries) for k, c in tr.forward_graphs.items()} == {
        "diag": 1, "traj": 1, "world2pix": 1, "gather_project": 1}
    assert graphs.REPLAYS["traj"] == 2 and graphs.REPLAYS["gather_project"] == 2
    # the K escalation and a capacity growth each make a new diag entry
    tr.render_config = dataclasses.replace(tr.render_config, max_per_tile=96)
    tr._diag_views()
    tr._grow_capacity(1024)
    tr._diag_views()
    assert len(tr.forward_graphs["diag"].entries) == 3


def jax_scene_inputs():
    xyz, scale, rotate, opacity, rgb, intr = scene()
    return (*(jnp.asarray(a) for a in (xyz, scale, rotate, opacity, rgb, intr)),
            jnp.asarray(extr_of(0.02)))


def test_render_jit_and_render_traj_jit_match_jax(fake, interpret):
    jargs = jax_scene_inputs()
    targs = tensors(*scene()) + (extr_of(0.02),)
    outs = ("rgb", "uv", "depth", "depth_map", "depth_map_color", "acc", "center")
    want = j_render_jit(*jargs, 0.2, W, H, outs, JConfig(**CFG, backend="pallas"))
    got = trender.render_jit(*targs, 0.2, W, H, outs, TConfig(**CFG), device="cpu")
    for k in outs:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "depth_map_color":
            assert (np.abs(g - w).max(-1) > 2e-2).mean() <= 5e-3
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5, err_msg=k)
    arrays = traj_line_set(300, 512, W=W, H=H)
    jcfg = JConfig(max_per_tile=128, max_tiles_per_gaussian=8, backend="pallas")
    tcfg = TConfig(max_per_tile=128, max_tiles_per_gaussian=8)
    for n_actual in (300, 120):
        want = np.asarray(j_render_traj_jit(*(jnp.asarray(a) for a in arrays), 0.0, W, H, 16,
                                            0.5, 2.0, jcfg, n_actual=n_actual))
        got = trender.render_traj_jit(*tensors(*arrays), 0.0, W, H, 16, 0.5, 2.0, tcfg,
                                      n_actual=n_actual, device="cpu").numpy()
        assert got.max() > 0.1
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    assert graphs.REPLAYS == {"render": 1, "render_traj": 2}


def test_diag_and_gather_project_match_jax(fake, interpret):
    """The trainer's diagnostic views (one graph) against JAX's
    _compiled_diag, and gather_project against _compiled_gather_project,
    on the same raw parameters and frame state."""
    tr = trainer_with(True)
    p, s = tr.params, tr.state
    jp = JParams(*(jnp.asarray(x.numpy()) for x in p))
    js = j_init_frame_state(CAP)._replace(
        n_alive=jnp.asarray(int(s.n_alive), jnp.int32),
        last_num=jnp.asarray(int(s.last_num), jnp.int32),
        still_mask=jnp.asarray(s.still_mask.numpy()))
    jintr = jnp.asarray(tr.intr.numpy())
    want = jtrainer._compiled_diag(tr.bg, W, H, JConfig(**CFG, backend="pallas"))(jp, js, jintr)
    got = tr._diag_views()
    assert set(got) == set(want)
    for k in got:
        diff = np.abs(got[k].astype(int) - np.asarray(want[k]).astype(int))
        if k == "depth_map_color":
            assert (diff.max(-1) > 1).mean() <= 5e-3, k
        else:
            assert diff.max() <= 1, k
        assert got[k].dtype == np.uint8
    query = np.arange(0, N, 7)
    sel, uv = tr.gather_project(query)
    jsel, juv = jtrainer._compiled_gather_project()(jp.xyz, jnp.asarray(query, jnp.int32),
                                                     jintr, jp.pose)
    np.testing.assert_array_equal(sel, np.asarray(jsel))
    np.testing.assert_allclose(uv, np.asarray(juv), atol=1e-4)
    assert graphs.REPLAYS["diag"] == 1 and graphs.REPLAYS["gather_project"] == 1


@pytest.mark.parametrize("entry", ["render_jit", "render_traj_jit"])
def test_graphed_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = tensors(*traj_line_set(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "render_jit":
            trender.render_jit(*arrays, 0.0, 64, 48, ("rgb",))
        else:
            trender.render_traj_jit(*arrays, 0.0, 64, 48, 2)
