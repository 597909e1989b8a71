"""CLI: python -m gflow_tpu_torch.cli.split_tapvid --pkl-path tapvid_davis.pkl \
--out-root data/davis (the flags of gflow_tpu.cli.split_tapvid)."""
from ..pipeline.split_tapvid import main
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(main, prog="split_tapvid")
