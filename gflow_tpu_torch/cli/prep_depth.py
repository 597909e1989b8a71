"""CLI: python -m gflow_tpu_torch.cli.prep_depth --img-dir <seq> --checkpoint <pth|npz>
(the flags of gflow_tpu.cli.prep_depth; --device cpu runs on the CPU).
The stage's phases (``utils.profiling.current``) are written to
<seq>_depth_mast3r_s2/telemetry.json."""
import os

from ..pipeline.prep_depth import main
from ..utils.cli import run_cli
from ..utils.profiling import current

if __name__ == "__main__":
    out_dir = run_cli(main, prog="prep_depth")
    current().dump(os.path.join(out_dir, "telemetry.json"))
