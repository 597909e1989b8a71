"""CLI: python -m gflow_tpu_torch.cli.benchmark_multi --path <dataset_root>
(the flags of gflow_tpu.cli.benchmark_multi; --device cpu runs on the CPU)."""
from ..eval.benchmark_multi import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="benchmark_multi")
