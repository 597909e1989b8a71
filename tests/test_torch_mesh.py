"""The port's device meshes (gflow_tpu_torch.parallel.mesh) on the CPU:
mesh shapes as the JAX package's (tests/test_multichip.py:8-12), the
refusal to split over more cards than are visible, the ambient mesh that
RenderConfig.for_scene reads, and sharded_batch_apply on 4 CPU replicas
against the unsharded call (atol 1e-6: the same model on the same
inputs, in batches of another size)."""
import pytest
import torch

from gflow_tpu_torch.ops.render import RenderConfig
from gflow_tpu_torch.parallel import mesh as pmesh
from gflow_tpu_torch.parallel.mesh import (ambient_tile_devices, fitting_mesh, make_mesh,
                                           sharded_batch_apply, use_mesh)

CPU = torch.device("cpu")


def test_make_mesh_shapes():
    assert make_mesh(8, device="cpu").shape == {"data": 2, "tile": 4}
    assert make_mesh(6, device="cpu").shape == {"data": 2, "tile": 3}
    assert make_mesh(2, device="cpu").shape == {"data": 1, "tile": 2}
    m = make_mesh(4, data_parallel=4, device="cpu")
    assert m.shape == {"data": 4, "tile": 1} and m.flat == (CPU,) * 4
    explicit = make_mesh(device=["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert explicit.devices == ((torch.device("cuda:0"), torch.device("cuda:1")),) * 2
    assert fitting_mesh(3, "cpu").shape == {"tile": 3}
    assert fitting_mesh(device=["cuda:0"] * 4).flat == (torch.device("cuda:0"),) * 4
    with pytest.raises(ValueError):
        fitting_mesh(3, device=["cuda:0", "cuda:1"])


def test_cuda_meshes_refuse_missing_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert fitting_mesh(2).flat == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="4 CUDA devices requested but 2 visible"):
        fitting_mesh(4)
    with pytest.raises(RuntimeError, match="visible"):
        make_mesh(4, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 visible"):
        fitting_mesh(1, "cuda")


def test_use_mesh_sets_and_clears_the_ambient_mesh():
    assert pmesh.current_mesh() is None and ambient_tile_devices() is None
    assert RenderConfig.for_scene(64, 48, 300).band_devices is None
    outer = fitting_mesh(4, "cpu")
    with use_mesh(outer):
        assert pmesh.current_mesh() is outer
        assert ambient_tile_devices() == (CPU,) * 4
        assert RenderConfig.for_scene(64, 48, 300).band_devices == (CPU,) * 4
        with use_mesh(make_mesh(8, device="cpu")):  # data and tile flattened
            assert len(ambient_tile_devices()) == 8
        assert pmesh.current_mesh() is outer
        with use_mesh(pmesh.Mesh((CPU, CPU), ("data",))):  # no tile axis: unbanded
            assert ambient_tile_devices() is None
    assert pmesh.current_mesh() is None
    with pytest.raises(KeyError):
        with use_mesh(outer):
            raise KeyError("the mesh is cleared on the way out")
    assert pmesh.current_mesh() is None


class TwoOutputs(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)

    def forward(self, a, b):
        x = self.conv(a.permute(0, 3, 1, 2)) - self.conv(b.permute(0, 3, 1, 2))
        return x.mean(dim=(2, 3)), {"map": x.permute(0, 2, 3, 1), "sum": x.sum(dim=(1, 2, 3))}


def test_sharded_batch_apply_matches_unsharded():
    torch.manual_seed(0)
    model = TwoOutputs().eval()
    a, b = torch.randn(8, 12, 10, 3), torch.randn(8, 12, 10, 3)
    run = sharded_batch_apply(model, make_mesh(4, data_parallel=4, device="cpu"))
    assert run.devices == (CPU,) * 4
    with torch.inference_mode():
        got, want = run(a, b), model(a, b)
        per_frame = [model(a[i:i + 1], b[i:i + 1]) for i in range(8)]
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    for k in ("map", "sum"):
        assert got[1][k].shape == want[1][k].shape
        torch.testing.assert_close(got[1][k], want[1][k], atol=1e-6, rtol=0)
    # each replica's chunk is its own call: batch 2 per replica
    torch.testing.assert_close(got[1]["sum"][:1], per_frame[0][1]["sum"], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        run(a[:6], b[:6])
