"""Port parity: convert_weights (gflow_tpu_torch.cli.convert_weights and the
port's copies of the two converters) against the JAX package's on the
CPU: the --dry-run key inventories print the same text, manifests pass
and fail alike, and a released-layout .pth converts to an .npz with the
same keys and bit-equal arrays. MASt3R's .pth conversion runs in the
released layout at small widths (encoder 32, decoder 24) and depths (2 +
2 blocks), through the module, which takes the depths (the CLI converts
released depths; compressing the released widths' ~100M random floats
takes minutes here)."""
import json

import numpy as np
import pytest
import torch

from gflow_tpu.cli.convert_weights import main as jax_cli
from gflow_tpu.models.mast3r import convert as jmconvert
from gflow_tpu.models.unimatch import convert as juconvert
from gflow_tpu_torch.cli.convert_weights import main as port_cli
from gflow_tpu_torch.models.mast3r import convert as mconvert
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.unimatch import convert as uconvert
from gflow_tpu_torch.utils.cli import run_cli
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


def printed(capsys, cli, argv):
    run_cli(cli, argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("model", ["mast3r", "unimatch"])
def test_dry_run_inventory_prints_the_same(capsys, model):
    got = printed(capsys, port_cli, ["--model", model, "--dry-run"])
    want = printed(capsys, jax_cli, ["--model", model, "--dry-run"])
    assert got == want and len(json.loads(got)["expected_keys"]) > 150


@pytest.mark.parametrize("model,head", [("unimatch", None), ("mast3r", "catmlp+dpt"),
                                        ("mast3r", "linear")])
def test_manifest_checks_agree(capsys, tmp_path, model, head):
    mf = {k: list(s) for k, s in (uconvert.expected_torch_keys() if model == "unimatch"
                                  else mconvert.expected_torch_keys(head=head)).items()}
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(mf))
    argv = ["--model", model, "--dry-run", "--manifest", str(path)]
    got = printed(capsys, port_cli, argv)
    assert got == printed(capsys, jax_cli, argv) and json.loads(got)["ok"]
    for bad in ({**mf, "not.a.real.key": [3, 3]},
                {k: v for k, v in mf.items() if not k.endswith("norm1.weight")}):
        path.write_text(json.dumps(bad))
        for cli in (port_cli, jax_cli):
            with pytest.raises(KeyError):
                run_cli(cli, argv)


def assert_same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files) and len(x.files) > 100
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_unimatch_pth_converts_like_jax(capsys, tmp_path):
    sd = seeded_state_dict(uconvert.expected_torch_keys(), seed=0)
    torch.save({"model": {**sd, "upsampler.2.bias": torch.zeros(144)}}, tmp_path / "g.pth")
    argv = ["--model", "unimatch", "--checkpoint-path", str(tmp_path / "g.pth"), "--out-path"]
    assert printed(capsys, port_cli, argv + [str(tmp_path / "port.npz")]).strip() == str(
        tmp_path / "port.npz")
    printed(capsys, jax_cli, argv + [str(tmp_path / "jax.npz")])
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    with pytest.raises(ValueError):
        port_cli("unimatch")
    with pytest.raises(ValueError):
        port_cli("raft", dry_run=True)


@pytest.mark.parametrize("head", ["catmlp+dpt", "linear"])
def test_mast3r_pth_converts_like_jax(tmp_path, head):
    sd = seeded_state_dict(mconvert.expected_torch_keys(2, 2, 32, 24, 16, head, 6), seed=1)
    torch.save({"model": {**sd, "mask_token": torch.zeros(1, 1, 32)}, "args": "..."},
               tmp_path / "m.pth")
    mconvert.convert_file(str(tmp_path / "m.pth"), str(tmp_path / "port.npz"), 2, 2)
    jmconvert.convert_file(str(tmp_path / "m.pth"), str(tmp_path / "jax.npz"), 2, 2)
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert mconvert.detect_head(sd) == jmconvert.detect_head(sd) == head


def test_state_dict_converts_like_jax():
    """convert_state_dict itself (the copied rule table), both models."""
    sd = {k: v.numpy() for k, v in seeded_state_dict(uconvert.expected_torch_keys(2, 32), 2).items()}
    got, want = uconvert.convert_state_dict(sd, 2), juconvert.convert_state_dict(sd, 2)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
