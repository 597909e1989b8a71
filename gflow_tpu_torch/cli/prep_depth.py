"""CLI: python -m gflow_tpu_torch.cli.prep_depth --img-dir <seq> --checkpoint <pth|npz>
(the flags of gflow_tpu.cli.prep_depth; --device cpu runs on the CPU)."""
from ..pipeline.prep_depth import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="prep_depth")
