"""Whole runs at a tiny size on the CPU with the timed path broken
underneath, the harness's look for a card skipped: each fault a cell can
have turns ``correct`` false. (No cell spans chips, so the exchange
between chips has no fault to plant.)"""
import pytest
import torch

from tiny import tiny_run


def _unchanged_step(monkeypatch):
    """The fit's step returns its state unchanged."""
    from gflow_tpu_torch.opt import train

    monkeypatch.setattr(train, "adam_update", lambda params, grads, opt, *lr: (params, opt))


def _half_batch(monkeypatch):
    """The fit's loss leaves half of its pixels out."""
    from gflow_tpu_torch.opt import train

    orig = train.compute_losses

    def half(rgb, depth_map, *args, **kw):
        targets = args[5]
        H = rgb.shape[0]
        keep = (torch.arange(H, device=rgb.device) < H // 2)[:, None, None]
        rgb = torch.where(keep, rgb, targets.image)
        depth_map = torch.where(keep, depth_map, targets.depth)
        return orig(rgb, depth_map, *args, **kw)

    monkeypatch.setattr(train, "compute_losses", half)


def _altered_composite(monkeypatch):
    """The compositor's output altered where it is produced."""
    from gflow_tpu_torch.ops import cuda_raster

    orig = cuda_raster.packed_composite

    def altered(*a, **k):
        res = orig(*a, **k)
        return (res[0] + 1e-2, res[1]) if isinstance(res, tuple) else res + 1e-2

    monkeypatch.setattr(cuda_raster, "packed_composite", altered)


def _altered_flow(monkeypatch):
    """prep_flow writes a flow other than the one it computed."""
    from gflow_tpu_torch.pipeline import prep_flow

    orig = prep_flow.write_flow
    monkeypatch.setattr(prep_flow, "write_flow", lambda path, f: orig(path, f + 0.5))


def _altered_occlusion(monkeypatch):
    """prep_flow's occlusion inverted where the fwd-bwd check produces it."""
    from gflow_tpu_torch.pipeline import prep_flow

    orig = prep_flow.forward_backward_consistency

    def inverted(*a, **k):
        occ_f, occ_b = orig(*a, **k)
        return occ_f, 1.0 - occ_b

    monkeypatch.setattr(prep_flow, "forward_backward_consistency", inverted)


def _altered_mask(monkeypatch):
    """prep_moveseg's open mask inverted where it is produced."""
    import scipy.ndimage

    orig = scipy.ndimage.binary_opening
    monkeypatch.setattr(scipy.ndimage, "binary_opening", lambda *a, **k: ~orig(*a, **k))


def _unchanged_alignment(monkeypatch):
    """The global alignment's Adam steps return their state unchanged."""
    from gflow_tpu_torch.models.mast3r import alignment

    monkeypatch.setattr(alignment, "_adam_steps", lambda buf, n, *a, **k: {})


def _zero_error_map(monkeypatch):
    """prep_moveseg's error map zeroed where it is produced."""
    from gflow_tpu_torch.pipeline import prep_moveseg

    monkeypatch.setattr(prep_moveseg, "sampson_error",
                        lambda x1, x2, F: torch.zeros(x1.shape[0], device=x1.device))


def _stage_cut_short(monkeypatch):
    """The fit's stages stop after half of their iterations, the rest of
    the loss trace left at zero."""
    import dataclasses

    from gflow_tpu_torch.pipeline import trainer

    orig = trainer.train_stage

    def short(params, state, targets, intr, gen, cfg, dyn, **kw):
        half = dataclasses.replace(cfg, iterations=cfg.iterations // 2)
        params, state, info = orig(params, state, targets, intr, gen, half, dyn, **kw)
        trace = torch.zeros(cfg.iterations, device=info["loss_trace"].device)
        trace[: half.iterations] = info["loss_trace"]
        return params, state, dict(info, loss_trace=trace)

    monkeypatch.setattr(trainer, "train_stage", short)


FAULTS = [("fit-davis480-moving", _unchanged_step), ("fit-davis480-moving", _half_batch),
          ("fit-davis480-moving", _altered_composite), ("prep-davis480-seq16", _altered_flow),
          ("prep-davis480-seq16", _altered_occlusion), ("prep-davis480-seq16", _altered_mask),
          ("prep-davis480-seq16", _unchanged_alignment),
          ("prep-davis480-seq16", _zero_error_map),
          ("fit-davis480-moving", _stage_cut_short)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}"
                                                    for c, f in FAULTS])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    rec = tiny_run(cell)
    assert rec["correct"] is False
    assert any(c["value"] > c["limit"] for c in rec["checks"].values())
    assert list(rec)[-1] == "checks"
