"""CLI: python -m gflow_tpu_torch.cli.prep_moveseg --img-dir <seq>
(the flags of gflow_tpu.cli.prep_moveseg; --device cpu runs on the CPU).
The stage's phases (``utils.profiling.current``) are written to
<seq>_epipolar/telemetry.json."""
import os

from ..pipeline.prep_moveseg import main
from ..utils.cli import run_cli
from ..utils.profiling import current

if __name__ == "__main__":
    out_dir = run_cli(main, prog="prep_moveseg")
    current().dump(os.path.join(out_dir, "telemetry.json"))
