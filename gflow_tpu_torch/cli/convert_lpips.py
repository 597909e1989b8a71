"""CLI: python -m gflow_tpu_torch.cli.convert_lpips --alexnet-path alexnet.pth \
--lins-path alex.pth --out-path lpips_alex.npz

Converts the public torchvision AlexNet + LPIPS v0.1 lin weights into the
.npz eval/metrics.py consumes (point $GFLOW_LPIPS_WEIGHTS at the output)."""
from ..eval.lpips_convert import convert_files
from ..utils.cli import run_cli

if __name__ == "__main__":
    run_cli(convert_files, prog="convert_lpips")
