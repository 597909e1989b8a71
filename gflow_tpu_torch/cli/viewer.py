"""CLI: python -m gflow_tpu_torch.cli.viewer --folder <logdir> --port 8080
(the flags of gflow_tpu.cli.viewer; --device cpu renders on the CPU)."""
from ..viz.viewer import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="viewer")
