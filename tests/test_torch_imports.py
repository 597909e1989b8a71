"""Guard: the port (gflow_tpu_torch/ and chip_smoke.py) imports neither
jax nor anything of the JAX package gflow_tpu — not even its NumPy-only
modules (gflow_tpu/core/__init__.py imports jax). Note that the port's own
name shares the prefix "gflow_tpu"."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "gflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "gflow_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_guard_detects_the_jax_package():
    assert forbidden("jax.numpy") and forbidden("gflow_tpu.core.sampling")
    assert not forbidden("gflow_tpu_torch.ops.binning") and not forbidden("torch")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_the_slice_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/camera.py", "core/scene.py", "core/sampling.py", "ops/reference.py",
                "ops/projection.py", "ops/binning.py", "ops/composite.py",
                "ops/cuda_raster.py", "ops/_build.py", "ops/render.py", "viz/colormap.py",
                "opt/state.py", "opt/losses.py", "opt/densify.py", "opt/initialize.py",
                "opt/train.py", "convert.py", "core/io.py", "utils/hull.py",
                "utils/tracking.py", "utils/cli.py", "utils/bgwriter.py", "utils/profiling.py",
                "viz/video.py", "viz/mjpeg_avi.py", "viz/traj_visualizer.py",
                "pipeline/trainer.py", "pipeline/fit_video.py", "cli/fit_video.py",
                "eval/metrics.py", "eval/lpips_convert.py", "eval/tapvid.py", "eval/davis.py",
                "eval/camera_eval.py", "eval/benchmark.py", "eval/benchmark_multi.py",
                "viz/viewer.py", "pipeline/split_tapvid.py", "cli/benchmark.py",
                "cli/benchmark_multi.py", "cli/convert_lpips.py", "cli/split_tapvid.py",
                "cli/viewer.py", "models/__init__.py", "models/precision.py",
                "models/random_weights.py", "models/unimatch/__init__.py",
                "models/unimatch/gmflow.py", "models/unimatch/convert.py",
                "models/mast3r/__init__.py", "models/mast3r/vit.py", "models/mast3r/dpt_head.py",
                "models/mast3r/convert.py", "models/mast3r/alignment.py", "ops/epipolar.py",
                "pipeline/prep_flow.py", "pipeline/prep_moveseg.py", "pipeline/prep_depth.py",
                "cli/prep_flow.py", "cli/prep_moveseg.py", "cli/prep_depth.py",
                "cli/convert_weights.py", "parallel/__init__.py", "parallel/mesh.py",
                "parallel/multichip.py", "parallel/scene_sweep.py", "cli/fit_multi.py",
                "ops/stamp.py", "ops/ssim.py", "models/attention.py", "models/sam/__init__.py",
                "models/sam/image_encoder.py", "models/sam/decoder.py", "models/sam/model.py",
                "models/sam/convert.py", "pipeline/prep_mask.py", "cli/prep_mask.py"):
        assert f"gflow_tpu_torch/{mod}" in names, mod


CHIP_SMOKE = ROOT / "chip_smoke.py"
# the tools that may import chip_smoke.py: its A/B and replay scripts and the port's tests
TOOL_FILES = [p for p in sorted((ROOT / "scripts").glob("torch_*.py"))
              + sorted((ROOT / "tests").glob("test_torch_*.py"))
              if "chip_smoke" in p.read_text()]


def module_level_names(path: Path) -> set:
    """The names `path` binds at module level: functions, classes, the
    targets of assignments and imports."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in getattr(node, "targets", [getattr(node, "target", None)]):
                names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def chip_smoke_uses(path: Path) -> set:
    """The names `path` reads off chip_smoke: `<alias>.<name>` where
    `import chip_smoke [as alias]`, and `from chip_smoke import <name>`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    aliases, names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            aliases.update(a.asname or a.name for a in node.names if a.name == "chip_smoke")
        elif isinstance(node, ast.ImportFrom) and node.module == "chip_smoke":
            names.update(a.name for a in node.names)
    names.update(node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
                 and isinstance(node.value, ast.Name) and node.value.id in aliases)
    return names


@pytest.mark.parametrize("path", TOOL_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_tools_use_only_what_chip_smoke_defines(path):
    """Every name a script or test reads off chip_smoke.py is bound there,
    read through ast without importing chip_smoke: a deletion from it that
    strands a tool fails here, on the CPU."""
    missing = chip_smoke_uses(path) - module_level_names(CHIP_SMOKE)
    assert not missing, f"{path.relative_to(ROOT)} uses chip_smoke's {sorted(missing)}"
