"""CLI: python -m gflow_tpu_torch.cli.benchmark --log-path ... --sequence-path ...
(the flags of gflow_tpu.cli.benchmark; --device cpu runs on the CPU)."""
from ..eval.benchmark import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="benchmark")
