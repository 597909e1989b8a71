"""Multi-GPU modes: device meshes and the tile-band fitting mode
(``mesh``), the batched B-frame harness and dry runs (``multichip``), and
the scene sweep, one worker process per device (``scene_sweep``).
Counterpart of ``gflow_tpu/parallel``; ``multichip`` and ``scene_sweep``
are imported by name (they import the stages, which import ``mesh``)."""
from .mesh import (Mesh, ambient_tile_devices, fitting_mesh, make_mesh, sharded_batch_apply,
                   use_mesh)

__all__ = ["Mesh", "ambient_tile_devices", "fitting_mesh", "make_mesh", "sharded_batch_apply",
           "use_mesh"]
