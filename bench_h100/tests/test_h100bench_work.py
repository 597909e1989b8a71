"""The operation and byte counters on small cases counted by hand."""
import pytest
import torch

from harness.device import PEAK_BYTES, PEAK_FP32_FLOPS, least_seconds
from work import composite, fit_step, prep_flops


def test_compositor_counts():
    assert composite.ops_k1(4) == 28 and composite.ops_k2(4) == 30 and composite.ops_k3(4) == 55
    # 10 pairs, 3 Gaussians of F = 1, 2 tiles of K = 4, 6 pixels
    ops, nbytes = composite.forward(10, 3, 1, 2, 4, 6)
    assert ops == 10 * 22
    assert nbytes == 4 * (3 * 7 + 2 * 4 + 2 + 6 * 1)
    ops, nbytes = composite.backward(10, 3, 1, 2, 4, 6)
    assert ops == 10 * 43 and nbytes == 4 * (3 * 7 + 8 + 2 + 6 + 3 * 7)


def test_least_seconds_is_the_larger_bound():
    assert least_seconds(PEAK_FP32_FLOPS, 0) == pytest.approx(1.0)
    assert least_seconds(1.0, PEAK_BYTES * 2) == pytest.approx(2.0)


def test_live_counts_clip_at_k_and_at_the_image_edge():
    # a 20x17 image: 2x2 tiles of 16; the right column has 4 pixel columns,
    # the bottom row 1 pixel row
    counts = torch.tensor([5, 3, 200, 1])
    live, pairs = fit_step.live_counts(counts, 4, 20, 17)
    assert live == 4 + 3 + 4 + 1
    assert pairs == 4 * 256 + 3 * 16 * 4 + 4 * 16 * 1 + 1 * 4 * 1


def test_fit_step_parts():
    p = fit_step.parts(capacity=2, pairs=10, live_slots=3, T=1, K=4, M=8, W=4, H=2)
    assert p["projection"][0] == 3 * 120 * 2
    assert p["binning"] == (0.0, 4 * 16 + 16 * 16 + 8 * 3 + 4 * (4 + 1))
    n = 2 * 14 + 9
    assert p["adam"] == (15.0 * n, 4.0 * 2 * n + 4.0 * 7 * n)
    assert fit_step.least_seconds_of(p) == pytest.approx(
        sum(least_seconds(*v) for v in p.values()))


def test_prep_pair_counts():
    assert prep_flops.n_pairs_logwin(16, 3) == 82   # 15 + 14 + 12, both ways
    assert prep_flops.pad(854, 32) == 864 and prep_flops.short_side(480, 854, 288) == (288, 512)


def test_prep_flops_from_shapes_on_meta():
    cfg = {"gmflow": {"feature_channels": 32, "num_transformer_layers": 1, "num_reg_refine": 1,
                      "attn_splits_list": [2, 4]},
           "mast3r": {"enc_dim": 32, "enc_depth": 1, "enc_heads": 2, "dec_dim": 24,
                      "dec_depth": 1, "dec_heads": 2, "desc_dim": 6, "head": "catmlp+dpt"},
           "padding_factor": 32, "inference_size": 32, "winsize": 3}
    w = prep_flops.sequence_flops(cfg, {"width": 96, "height": 64}, 4)
    assert w["gmflow"] == 2 * 3 * w["gmflow_pair"] > 0
    assert w["mast3r"] == prep_flops.n_pairs_logwin(4, 3) * w["mast3r_pair"] > 0
