"""CLI entry: python -m gflow_tpu_torch.cli.fit_multi --path <dataset_root>
(scene-parallel dataset fitting, one worker process per card; --device
cpu sweeps in one CPU worker)."""
from ..parallel.scene_sweep import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="fit_multi")
