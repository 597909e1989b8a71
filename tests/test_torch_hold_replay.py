"""chip_smoke.py's compositor hold (hold_composite) on the CPU: a failing
hold saves its packed compositor call, scripts/torch_replay_composite.py
replays that record through the float32 and float64 plain versions, and a
real fault (one pixel moved by 1e-4 where no slot sits at one of alpha's
steps and no splat is ill-conditioned) still fails the hold, while the
float32 rounding under an ill-conditioned splat (chip_smoke.rounding_bound)
is explained, as in the viewer hold's failure caught on an H100
(tests/data/viewer_hold_h100.pt).

A small packed call made from a seed with NumPy: 4 tiles of 16x16 (2 x 2),
K = 24 slots, F = 3, well-conditioned conics. Tolerances: the float32 plain
version within 1e-5 of float64 (the viewer hold's atol, which it holds on
the card)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402  (torch_replay_composite put the root on sys.path)
import torch_replay_composite as replay  # noqa: E402
from gflow_tpu_torch.ops import composite  # noqa: E402

N_TX, T, K, F = 2, 4, 24, 3


def packed_call(seed=0):
    """A seeded packed compositor call on the CPU in chip_smoke's record
    form, with its float32 plain output."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    origin = np.stack([(t % N_TX) * 16.0, (t // N_TX) * 16.0], -1)
    uv = origin[:, None] + rng.uniform(-4, 20, (T, K, 2))
    a, c = rng.uniform(0.02, 0.3, (2, T, K, 1))
    b = rng.uniform(-0.3, 0.3, (T, K, 1)) * np.sqrt(a * c)
    cols = [uv, a, b, c, rng.uniform(0.05, 0.95, (T, K, 1)), rng.uniform(0, 1, (T, K, F))]
    attrs = torch.from_numpy(np.concatenate(cols, -1).astype(np.float32))
    counts = torch.from_numpy(rng.integers(K // 2, K + 1, T).astype(np.int32))
    bg = torch.zeros(F)
    rec = dict(attrs=attrs, counts=counts, bg=bg, n_tx=N_TX, with_cov=False, row0=0)
    return rec, composite.composite_packed(attrs, counts, bg, N_TX)


def quiet_pixel(rec):
    """(tile, pixel) of the first pixel with a lit slot where no slot sits
    at one of alpha's steps and the float32 rounding bound is below 1e-6."""
    t, p = torch.meshgrid(torch.arange(T), torch.arange(256), indexing="ij")
    t, p = t.flatten(), p.flatten()
    steps = cs.cutoff_bound(rec, t, p)
    bound = cs.rounding_bound(rec, t, p)
    ok = (steps == 0) & (bound > 0) & (bound < 1e-6)
    i = int(ok.nonzero()[0])
    return int(t[i]), int(p[i])


@pytest.fixture
def failures(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "HOLD_FAILURES", str(tmp_path / "hold_failures"))
    return tmp_path / "hold_failures"


def moved_record(failures):
    """The call with one quiet pixel of the 'kernel' output moved by 1e-4,
    held as the viewer holds it; returns the hold's error, the saved
    record's path and the pixel."""
    rec, want = packed_call()
    ti, pi = quiet_pixel(rec)
    got = want.clone()
    got[ti, pi, 1] += 1e-4
    with pytest.raises(AssertionError) as err:
        cs.hold_composite(got, want, rec, atol=1e-5, rtol=0, phase="viewer", view="follow 0")
    return err.value, failures / "viewer-follow_0.pt", (ti, pi)


def test_moved_pixel_fails_the_hold_and_saves_the_call(failures):
    err, path, (ti, pi) = moved_record(failures)
    assert str(path) in str(err) and path.exists()
    rec = torch.load(path)
    assert {"attrs", "counts", "bg", "n_tx", "with_cov", "row0", "got", "want", "phase",
            "view"} <= set(rec)
    assert (rec["phase"], rec["view"], rec["n_tx"], rec["with_cov"], rec["row0"]) == (
        "viewer", "follow 0", N_TX, False, 0)
    assert rec["tiles"].tolist() == [ti] and rec["pixels"].tolist() == [pi]
    want_rec, want = packed_call()
    assert torch.equal(rec["attrs"], want_rec["attrs"]) and torch.equal(rec["want"], want)


def test_replay_on_cpu_reads_the_record(failures, capsys):
    """The replay's float32 plain version lies within 1e-5 of float64 at the
    failing pixel, and the moved value (standing for the kernel's) is
    called a fault: 1e-4 from float64, past the pixel's rounding bound."""
    _, path, (ti, pi) = moved_record(failures)
    rows = replay.main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and '"fault": 1' in out[-1]
    (row,) = rows
    assert (row["tile"], row["pixel"], row["kernel_replayed"]) == (ti, pi, False)
    assert row["plain_vs_f64"] <= 1e-5 and row["recorded_plain_vs_f64"] <= 1e-5
    assert row["kernel_vs_f64"] == pytest.approx(1e-4, rel=0.05)
    assert row["rounding_bound"] < 1e-6 and row["verdict"] == "fault"
    assert row["heavy_slots"] and all(s["weight"] > 1e-3 for s in row["heavy_slots"])


def test_replay_plain_matches_float64_everywhere():
    """The float32 plain version within 1e-5 of float64 at every pixel of
    the call (replay.outputs), and each pixel's float32 rounding bound
    covers the gap."""
    rec, want = packed_call(seed=1)
    out = replay.outputs(rec, torch.device("cpu"))
    assert torch.equal(out["plain"], want) and "kernel" not in out
    gap = (out["plain"].double() - out["f64"]).abs().amax(-1)
    assert float(gap.max()) <= 1e-5
    t, p = torch.meshgrid(torch.arange(T), torch.arange(256), indexing="ij")
    assert bool((gap.flatten() <= cs.rounding_bound(rec, t.flatten(), p.flatten())).all())


def test_ill_conditioned_splat_rounding_is_explained(failures):
    """A thin splat along the diagonal (conic a = c = 200, b = -199.9) in
    front at a pixel 4 px down its axis: power -1.6 from terms of ~6,400,
    whose float32 rounding moves alpha by ~1e-3 relative. A 1e-4 move there
    lies within twice the pixel's rounding bound and passes; the same move
    at a quiet pixel does not (test_moved_pixel_fails_the_hold...)."""
    rec, _ = packed_call()
    attrs = rec["attrs"].clone()
    attrs[0, 0, :6] = torch.tensor([8.0, 8.0, 200.0, -199.9, 200.0, 0.9])
    rec["attrs"] = attrs
    want = composite.composite_packed(attrs, rec["counts"], rec["bg"], N_TX)
    t, p = torch.tensor([0]), torch.tensor([12 * 16 + 12])
    assert float(cs.cutoff_bound(rec, t, p)) == 0
    assert 2 * float(cs.rounding_bound(rec, t, p)) > 1e-4 + 1e-5
    got = want.clone()
    got[0, 12 * 16 + 12, 0] += 1e-4
    # max_share: one pixel of the call's 1,024 (a view has 414,720)
    err, past = cs.hold_composite(got, want, rec, atol=1e-5, rtol=0, max_share=1 / (T * 256),
                                  phase="viewer", view="thin splat")
    assert past == 1 and err == pytest.approx(1e-4, rel=1e-3)
    assert not failures.exists()


def test_h100_viewer_record_is_explained_by_rounding(failures):
    """The viewer hold's failure caught on an NVIDIA H100 (700 W) by
    scripts/torch_viewer_hold_hunt.py, cut to its tile (tile 831 of 1620,
    shifted by whole tiles: dx and dy stay bitwise): the kernel 1.05e-5
    from the plain version at one pixel (atol 1e-5), no slot at a step;
    the kernel 3.9e-6 and the plain version 6.6e-6 from float64, under an
    ill-conditioned splat (weight 0.118, |power|'s terms 2,101 against
    power -2.10). alpha's steps alone do not explain it; with the float32
    rounding the hold passes, and the replay calls it rounding."""
    rec = torch.load(ROOT / "tests" / "data" / "viewer_hold_h100.pt")
    t, p = rec["tiles"], rec["pixels"]
    diff = float((rec["got"] - rec["want"]).abs()[t, p].max())
    assert diff > 1e-5 and float(cs.cutoff_bound(rec, t, p)) == 0
    # max_share: one pixel of the tile's 256 (the view's 1,620 tiles allow 41)
    err, past = cs.hold_composite(rec["got"], rec["want"], rec, atol=1e-5, rtol=0,
                                  max_share=1 / 256, phase="viewer", view="follow 2")
    assert past == 1 and err == diff and not failures.exists()
    (row,) = replay.replay(rec, torch.device("cpu"))
    assert row["verdict"] == "rounding" and row["kernel_vs_f64"] < row["plain_vs_f64"] <= 1e-5
