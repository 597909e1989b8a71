"""CLI entry: python -m gflow_tpu_torch.cli.fit_video --sequence-path ...
(the flags of gflow_tpu.cli.fit_video; --device cpu runs on the CPU)."""
from ..pipeline.fit_video import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="fit_video")
