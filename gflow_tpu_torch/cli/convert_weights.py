"""CLI: convert released torch checkpoints to the .npz files the JAX
package's prep stages load (this package's prep stages load either).

  python -m gflow_tpu_torch.cli.convert_weights --model mast3r \
      --checkpoint-path MASt3R_....pth --out-path mast3r.npz
  python -m gflow_tpu_torch.cli.convert_weights --model unimatch \
      --checkpoint-path gmflow-scale2-regrefine6-....pth --out-path flow.npz

Counterpart of ``gflow_tpu.cli.convert_weights``, through the port's
copies of the converters. No weights on hand? ``--dry-run --manifest
keys.json`` validates a {torch_key: shape} manifest against the full
strict mapping without any tensor data; ``--dry-run`` alone prints the
expected released checkpoint key inventory."""
import json
from typing import Optional


def main(model: str, checkpoint_path: Optional[str] = None, out_path: Optional[str] = None,
         dry_run: bool = False, manifest: Optional[str] = None):
    if model == "mast3r":
        from ..models.mast3r import convert as mod
    elif model == "unimatch":
        from ..models.unimatch import convert as mod
    else:
        raise ValueError(f"unknown model {model!r} (mast3r | unimatch)")
    if dry_run:
        mf = None
        if manifest is not None:
            with open(manifest) as f:
                mf = json.load(f)
        print(json.dumps(mod.dry_run(mf), indent=1))
        return
    if checkpoint_path is None or out_path is None:
        raise ValueError("--checkpoint-path and --out-path are required unless --dry-run")
    print(mod.convert_file(checkpoint_path, out_path))


if __name__ == "__main__":
    from ..utils.cli import run_cli

    run_cli(main, prog="convert_weights")
