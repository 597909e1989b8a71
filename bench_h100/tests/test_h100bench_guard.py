"""No file of the benchmark imports the JAX package or JAX, compared by the
whole top-level name of each import (the port, ``gflow_tpu_torch``, is
allowed); the plain reference imports nothing of the port either."""
import ast
from pathlib import Path

from harness import guard, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gflow_tpu"}


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(manifest.BENCH.rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    bad = {str(p): imported_top_levels(p) & FORBIDDEN for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = manifest.BENCH / "reference"
    bad = {str(p) for p in ref.rglob("*.py") if "gflow_tpu_torch" in imported_top_levels(p)}
    assert not bad


def test_names_compared_whole():
    assert guard.forbidden_modules({"gflow_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1}) == []
    assert guard.forbidden_modules({"gflow_tpu.core": 1, "jax.numpy": 1, "flax": 1}) == [
        "flax", "gflow_tpu", "jax"]
