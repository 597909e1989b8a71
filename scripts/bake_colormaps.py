"""Bake every matplotlib colormap into the port's table file,
gflow_tpu_torch/viz/colormaps.npz, so that the port needs no matplotlib.

    python3 scripts/bake_colormaps.py

For each name in matplotlib.colormaps it stores the 256 entries the JAX
package's lookup reads, cmap(arange(256) / 255)[:, :3] in float64, and the
map's own size N (colormap_lookup reproduces matplotlib's float lookup for
N = 256 maps only). Needs matplotlib; rerun it after a matplotlib upgrade.
"""
from pathlib import Path

import matplotlib
import numpy as np

OUT = Path(__file__).resolve().parent.parent / "gflow_tpu_torch" / "viz" / "colormaps.npz"


def main():
    names = sorted(matplotlib.colormaps)
    cmaps = [matplotlib.colormaps[n] for n in names]
    tables = np.stack([c(np.arange(256) / 255.0)[:, :3] for c in cmaps]).astype(np.float64)
    sizes = np.asarray([c.N for c in cmaps], np.int64)
    np.savez_compressed(OUT, names=np.asarray(names), tables=tables, sizes=sizes,
                        matplotlib=np.asarray(matplotlib.__version__))
    print(f"{len(names)} colormaps of matplotlib {matplotlib.__version__} -> {OUT} "
          f"({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
