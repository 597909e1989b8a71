"""The control on the card, at a size a test run holds: the reference put
in the program's place in the precision below the configuration's (the
cell's ``check.control``) reads above the cell's limits, where the program
reads within them. Marked ``cuda``: the full-size readings come from
``bench_h100/control.py`` (PERF.md)."""
import pytest

from harness import manifest
from tiny import TINY

# on the card the fit runs at the cell's own frame size and point count
# (the TF32 control's blend rounding shows at the K the full scene
# escalates to; at half the width it read within the loss limits), with
# few iterations and a 4-frame video
CARD = dict(TINY, **{"fit-davis480-moving": (
    {"period": 4},
    {"fit_video": {"iterations_first": 50, "iterations_camera": 6, "iterations_after": 12,
                   "densify_interval": 20, "densify_interval_after": 5}})})


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CARD))
def test_control_fails_where_the_program_passes(cell, card):
    import run as bench_run
    from harness.trace import Tracer
    import tempfile

    wl = manifest.workload(cell)
    traffic, config = CARD[cell]
    cfg = bench_run._merged(manifest.config(wl["config"]), config)
    driver = manifest.module("drivers", wl["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        run = bench_run.Run(cell, cfg, bench_run._merged(wl["traffic"], traffic), wl["check"],
                            2 ** 31 + 21, card, 1, tmp)
        s = driver.setup(run)
        driver.window(s, run, 1.0, Tracer(False))
        material = driver.release(s)
        limits = wl["check"]["limits"]
        program = driver.numbers(material, run)
        control = driver.numbers(material, run, wl["check"]["control"])
    print(cell, "program", program, "control", control)
    assert all(program[k] <= limits[k] for k in program), (program, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)
