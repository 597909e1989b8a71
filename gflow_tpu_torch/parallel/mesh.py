"""Device meshes for the multi-GPU modes.

Counterpart of ``gflow_tpu/parallel/mesh.py`` and of
``gflow_tpu/ops/render.py``'s ``ambient_tile_axes``. A mesh here is a grid
of ``torch.device``s with named axes:

- "data": scene- or batch-level data parallelism (prior-model inference
  over frame pairs, the B-frame harness of ``parallel/multichip.py``);
- "tile": the rasterizer's tile rows split into bands, one band per device
  (``ops/cuda_raster.composite_tiles_kernel_sharded``).

One Python process drives every device of a mesh: there are no ranks and
no collectives. ``use_mesh`` is the counterpart of ``jax.set_mesh``: inside
it, ``RenderConfig.for_scene`` gives every stage bands over the mesh's
devices (``ambient_tile_devices``).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
from dataclasses import dataclass

import torch

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("gflow_mesh", default=None)


@dataclass(frozen=True)
class Mesh:
    """`devices` nested one tuple level per axis of `axis_names`."""

    devices: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        sizes, level = {}, self.devices
        for name in self.axis_names:
            sizes[name] = len(level)
            level = level[0]
        return sizes

    @property
    def flat(self) -> tuple:
        """Every device, row-major (data, then tile)."""
        out = self.devices
        for _ in self.axis_names[1:]:
            out = tuple(d for row in out for d in row)
        return out


def visible_devices(n_devices: int | None = None, device=None) -> tuple:
    """`n_devices` devices of the kind `device` names: for ``cuda`` (the
    default) the first n visible cards, raising when fewer are visible;
    for ``cpu`` n entries of the CPU (n bands or replicas in one process,
    the counterpart of the tests' virtual CPU devices). `device` may also
    be an explicit sequence of devices (four bands on ``cuda:0``, say), of
    which the first n are taken."""
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(d) for d in device)
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"{n_devices} devices requested from a list of {len(devs)}")
            devs = devs[:n_devices]
        return devs
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if count < n or n < 1:
            raise RuntimeError(
                f"{n} CUDA devices requested but {count} visible: refusing to run the "
                "split on fewer cards than it asks for")
        return tuple(torch.device("cuda", i) for i in range(n))
    return (dev,) * (1 if n_devices is None else n_devices)


def make_mesh(n_devices: int | None = None, data_parallel: int | None = None,
              device=None) -> Mesh:
    """A ("data", "tile") mesh over `n_devices` devices (visible_devices).
    data_parallel defaults to 2 when n is even and at least 4, else 1."""
    devs = visible_devices(n_devices, device)
    n = len(devs)
    if data_parallel is None:
        data_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    tile = n // data_parallel
    if tile < 1:
        raise ValueError(f"data_parallel {data_parallel} exceeds the {n} devices")
    rows = tuple(tuple(devs[r * tile:(r + 1) * tile]) for r in range(data_parallel))
    return Mesh(rows, ("data", "tile"))


def fitting_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The 1-D ("tile",) mesh of the tile-band fitting mode: run a fit
    under ``use_mesh(fitting_mesh(n))`` and every stage configured by
    ``RenderConfig.for_scene`` composites its tile rows in n bands, one per
    device. Projection, binning, losses and Adam stay on the fit's own
    device; the bands' per-slot gradients come back through autograd and
    are summed by the packed gather's transpose. Raises when `device` is
    ``cuda`` and fewer than n cards are visible."""
    return Mesh(visible_devices(n_devices, device), ("tile",))


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make `mesh` the ambient mesh while the block runs (``jax.set_mesh``)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Mesh | None:
    return _AMBIENT.get()


def ambient_tile_devices() -> tuple | None:
    """The band devices of the ambient mesh: every device of its "data"
    and "tile" axes, flattened (a ("data", "tile") mesh bands a single
    frame over all of them). None outside a mesh or without a "tile" axis,
    the single-device default."""
    mesh = current_mesh()
    if mesh is None or "tile" not in mesh.axis_names:
        return None
    return mesh.flat


def sharded_batch_apply(model, mesh: Mesh, graphs=None):
    """Wrap a batched model call model(*batched) -> batched outputs so that
    the batch is split over the mesh's "data" axis: one replica of the
    model on the first device of each data row, chunk i of every input on
    replica i, the outputs (tensors, or tuples and dicts of them) back on
    the model's own device, concatenated. The batch must divide by the
    axis size; callers pad and crop. Each replica's forward goes through
    `graphs` (an ``opt.graphs.ForwardCache``; default: one of this call's
    own): on the cards, the replay of a CUDA graph of its own on its own
    card (``opt.graphs.module_call``). Replicas run one after another from
    this thread, so their device work overlaps as far as the model does
    not wait for the device; a replica on the model's device is the model
    itself."""
    from ..opt.graphs import ForwardCache, module_call

    cache = ForwardCache("replicas", 8) if graphs is None else graphs
    devs = [row[0] for row in mesh.devices]
    home = next(model.parameters()).device
    replicas = {}
    for d in devs:
        if d not in replicas:
            replicas[d] = model if d == home else copy.deepcopy(model).to(d)

    def apply(*batched):
        B = batched[0].shape[0]
        if B % len(devs):
            raise ValueError(f"batch {B} does not divide by the {len(devs)} data rows")
        per = B // len(devs)
        outs = [module_call(cache, replicas[d], *(x[i * per:(i + 1) * per] for x in batched),
                            device=d)
                for i, d in enumerate(devs)]
        return _concat(outs, home)

    apply.devices = tuple(devs)
    return apply


def _concat(outs, device):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    return type(first)(_concat(list(p), device) for p in zip(*outs))
