"""CLI: python -m gflow_tpu_torch.cli.prep_moveseg --img-dir <seq>
(the flags of gflow_tpu.cli.prep_moveseg; --device cpu runs on the CPU)."""
from ..pipeline.prep_moveseg import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="prep_moveseg")
