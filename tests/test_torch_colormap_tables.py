"""Port parity: the port's baked colormap tables (gflow_tpu_torch/viz/
colormaps.npz, scripts/bake_colormaps.py) against the JAX package's
matplotlib lookup. apply_float_colormap of every name in
matplotlib.colormaps (and "grey") equals gflow_tpu.viz.colormap's within
1e-6 on the same values; colormap_lookup equals matplotlib's own float
lookup for every 256-entry map; the hand-kept turbo and gist_rainbow
tables equal their baked entries."""
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from gflow_tpu.viz import colormap as j_colormap
from gflow_tpu_torch.viz import colormap as t_colormap


def values():
    """Depth-like values with zeros (the non_zero path), both ends of the
    range and every one of the 256 bins."""
    rng = np.random.default_rng(0)
    v = np.r_[0.0, 0.0, np.linspace(1.0, 3.0, 256), rng.uniform(1.0, 3.0, 500)]
    return v.astype(np.float32).reshape(-1, 1)


def test_every_matplotlib_colormap_matches_jax():
    names = sorted(matplotlib.colormaps)
    assert set(names) == set(t_colormap._baked())
    v = values()
    for name in [*names, "grey"]:
        for non_zero in (False, True):
            got = t_colormap.apply_float_colormap(torch.from_numpy(v), name, non_zero)
            want = np.asarray(j_colormap.apply_float_colormap(jnp.asarray(v), name, non_zero))
            assert got.dtype == torch.float32 and got.shape == (v.shape[0], 3)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0, err_msg=name)


def test_float_lookup_matches_matplotlib():
    u = np.r_[-0.5, np.linspace(0, 1, 1001), 1.0, 1.5]
    full = [n for n in sorted(matplotlib.colormaps) if matplotlib.colormaps[n].N == 256]
    assert len(full) > 100
    for name in full:
        np.testing.assert_array_equal(t_colormap.colormap_lookup(u, name),
                                      matplotlib.colormaps[name](u)[:, :3], err_msg=name)
    with pytest.raises(ValueError, match="256-entry"):
        t_colormap.colormap_lookup(u, "tab10")
    with pytest.raises(ValueError, match="unsupported colormap"):
        t_colormap.apply_float_colormap(torch.zeros(3, 1), "no_such_map")


def test_hand_kept_tables_equal_the_baked_ones():
    for name, table in (("turbo", t_colormap.TURBO), ("gist_rainbow", t_colormap.GIST_RAINBOW)):
        np.testing.assert_array_equal(np.asarray(table), t_colormap._baked()[name][0])
