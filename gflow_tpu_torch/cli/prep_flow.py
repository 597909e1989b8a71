"""CLI: python -m gflow_tpu_torch.cli.prep_flow --img-dir <seq> --checkpoint <pth|npz>
(the flags of gflow_tpu.cli.prep_flow; --device cpu runs on the CPU)."""
from ..pipeline.prep_flow import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="prep_flow")
