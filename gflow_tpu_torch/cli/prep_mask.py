"""CLI: python -m gflow_tpu_torch.cli.prep_mask --img-dir <seq> --checkpoint <pth>
(SAM's automatic mask generator at its defaults over every frame; the
masks that lie in <seq>_epipolar's moving-object mask, joined, to
<seq>_mask/<name>.png; --device cpu runs on the CPU). The stage's phases
and counters (``utils.profiling.current``) are written to
<seq>_mask/telemetry.json."""
import os

from ..pipeline.prep_mask import main
from ..utils.cli import run_cli
from ..utils.profiling import current

if __name__ == "__main__":
    out_dir = run_cli(main, prog="prep_mask")
    current().dump(os.path.join(out_dir, "telemetry.json"))
