"""The guard against the JAX package: the names of loaded modules whose
top-level name (the part before the first dot) is, whole, one that the
benchmark's process may not hold. ``gflow_tpu_torch`` is the port and
passes: its top-level name is not ``gflow_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gflow_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})
