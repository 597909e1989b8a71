"""CLI: python -m gflow_tpu_torch.cli.prep_track --img-dir <seq> [--annotation
<png>] --checkpoint <pt> (SAM 2 propagates the first frame's objects, from a
DAVIS-style palette annotation or <seq>_epipolar's moving-object mask,
through the sequence; the union of their masks to <seq>_mask/<name>.png;
--device cpu runs on the CPU). The stage's phases and counters
(``utils.profiling.current``) are written to <seq>_mask/telemetry.json."""
import os

from ..pipeline.prep_track import main
from ..utils.cli import run_cli
from ..utils.profiling import current

if __name__ == "__main__":
    out_dir = run_cli(main, prog="prep_track")
    current().dump(os.path.join(out_dir, "telemetry.json"))
