"""The mask prior stage (gflow_tpu_torch/pipeline/prep_mask.py) on the
CPU at a tiny size: SAM's grid of prompts, the stability filter, the
boxes, NMS against a brute-force pairwise loop, the union rule, the masks
the stage writes against the benchmark's plain generator
(bench_h100/reference/sam/generator.py) applied to the same decoder
outputs, its telemetry, the CLI with a checkpoint, and fit_video reading
what it wrote (the masks found, the object's Gaussians picked from the
first)."""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from gflow_tpu_torch.core.io import imread, imwrite
from gflow_tpu_torch.models.sam import SamModel
from gflow_tpu_torch.pipeline import prep_mask
from gflow_tpu_torch.utils import profiling
from tests.synth import make_sequence
from tests.test_torch_sam import TINY, reference, weights

# the decoder's weights x6 (x3 at the benchmark's widths): masks pass the
# filters
SCALE = {"image_encoder": 1.0, "prompt_encoder": 6.0, "mask_decoder": 6.0}


def scaled_weights(seed=0):
    sd = weights(seed=seed)
    for k, v in sd.items():
        if not k.endswith("positional_encoding_gaussian_matrix"):
            v.mul_(SCALE[k.split(".")[0]])
    return sd


def model(seed=0):
    m = SamModel(TINY)
    m.load_state_dict(scaled_weights(seed), strict=True)
    return m.eval()


def test_grid_is_sams_point_grid():
    _, gen, _ = reference()
    pts = prep_mask.point_grid(32, 480, 854)
    assert pts.shape == (1024, 2)
    assert np.allclose(pts[0], [854 / 64, 480 / 64]) and np.allclose(pts[1], [3 * 854 / 64,
                                                                              480 / 64])
    assert np.allclose(pts[32], [854 / 64, 3 * 480 / 64])
    want = gen.grid_points(32, (480, 854), 1024)
    assert np.allclose(pts * np.array([1024 / 854, 576 / 480]), want, rtol=0, atol=1e-9)


def test_post_keeps_by_iou_and_stability():
    g = torch.Generator().manual_seed(0)
    # sharp logits (stable masks) for half of the points, soft for the rest
    sharp = torch.tensor([200.0, 200.0, 1.0, 1.0])[:, None, None, None]
    low = torch.randn(4, 3, 40, 40, generator=g) * sharp
    low[:, :, :20] += 100.0
    iou = torch.rand(4, 3, generator=g) * 0.4 + 0.7
    out = torch.empty(12, 64, 96, dtype=torch.bool)
    kept_iou, kept = prep_mask.post(low, iou, (107, 160), (64, 96), 160, out)
    from gflow_tpu_torch.models.sam import postprocess_masks

    logits = postprocess_masks(low, (107, 160), (64, 96), 160).flatten(0, 1).numpy()
    for m in range(12):
        stab = (logits[m] > 1).sum() / (logits[m] > -1).sum()
        p = float(iou.flatten()[m])
        assert bool(kept_iou[m]) == (p > 0.88)
        assert bool(kept[m]) == (p > 0.88 and stab >= 0.95)
        assert np.array_equal(out[m].numpy(), logits[m] > 0)
    assert 0 < int(kept.sum()) < int(kept_iou.sum()) < 12


def test_boxes_of_masks():
    masks = torch.zeros(3, 6, 7, dtype=torch.bool)
    masks[0, 1:3, 2:5] = True
    masks[1, 5, 6] = True
    boxes = prep_mask.mask_boxes(masks)
    assert boxes.tolist() == [[2, 1, 4, 2], [6, 5, 6, 5], [0, 0, 0, 0]]


def brute_nms(boxes, scores, thresh):
    """Every box against every box: keep a box when no higher-scored kept
    box (ties: the lower index is higher) overlaps it above `thresh`."""
    def iou(a, b):
        w = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        h = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = w * h
        union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / union if union > 0 else float("nan")

    n = len(boxes)
    rank = sorted(range(n), key=lambda i: (-scores[i], i))
    kept = []
    for i in rank:
        if all(not iou(boxes[i], boxes[j]) > thresh for j in kept):
            kept.append(i)
    return kept


@pytest.mark.parametrize("seed", range(4))
def test_nms_is_the_pairwise_loop(seed):
    rng = np.random.default_rng(seed)
    n = 40
    xy = rng.integers(0, 30, (n, 2))
    wh = rng.integers(0, 12, (n, 2))  # some of zero width: zero area
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[5] = boxes[4]
    scores = rng.integers(0, 6, n).astype(np.float32)  # ties
    got = prep_mask.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3).tolist()
    assert got == brute_nms(boxes.tolist(), scores.tolist(), 0.3)
    _, gen, _ = reference()
    assert gen.nms(boxes, scores, 0.3) == got


def test_union_of_masks_half_inside():
    masks = torch.zeros(4, 4, 4, dtype=torch.bool)
    masks[0, :2, :2] = True            # 4 px, all inside
    masks[1, 2:, :] = True             # 8 px, 4 inside: exactly half
    masks[2, :, 3] = True              # 4 px, 1 inside
    inside = torch.zeros(4, 4, dtype=torch.bool)
    inside[:3, :3] = True
    inside[3, :1] = True
    union, n = prep_mask.union_inside(masks, inside, 0.5)
    assert n == 2 and torch.equal(union, masks[0] | masks[1])
    union, n = prep_mask.union_inside(masks[:0], inside, 0.5)
    assert n == 0 and not union.any() and union.shape == (4, 4)


@pytest.fixture(scope="module")
def masked(tmp_path_factory):
    """prep_mask.main on a 3-frame synthetic sequence, the decoder's outputs
    kept by a tap; frame 1's moving-object mask covers the whole frame, so
    that every mask NMS keeps there joins its union."""
    root = tmp_path_factory.mktemp("prep_mask")
    seq = make_sequence(root, n_frames=3, W=96, H=64, texture_octaves=2)
    imwrite(f"{seq}_epipolar/00001_open.png", np.full((64, 96), 255, np.uint8))
    kept = []
    enc, dec = prep_mask.encode, prep_mask.decode

    def tap(model, embedding, points, dev):
        low, iou = dec(model, embedding, points, dev)
        kept.append((low, iou))
        return low, iou

    tel = profiling.current()
    before = dict(tel.counters)
    prep_mask.decode = tap
    try:
        out = prep_mask.main(seq, device="cpu", model=model())
    finally:
        prep_mask.decode = dec
    counts = {k: v - before.get(k, 0) for k, v in tel.counters.items()}
    return seq, out, kept, counts


def test_writes_one_mask_a_frame(masked):
    seq, out, kept, counts = masked
    assert out == str(seq) + "_mask"
    names = sorted(os.listdir(out))
    assert names == ["00000.png", "00001.png", "00002.png"]
    for n in names:
        m = imread(os.path.join(out, n))
        assert m.shape == (64, 96) and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255}
    assert len(kept) == 3 * 16 and counts["mask/prompts"] == 3 * 1024
    assert counts["mask/kept_iou"] >= counts["mask/kept_stability"] >= counts["mask/kept_nms"] \
        >= counts["mask/kept_union"]
    # the filters, NMS and the union had masks to work on
    assert counts["mask/kept_union"] > 0 and counts["mask/kept_stability"] > 3


def test_no_batch_counts_as_fused_on_the_cpu(masked):
    """mask/decoder_fused_batches counts the batches whose decode launched
    the decoder's image-stream kernels: none on the CPU, where the plain
    versions run."""
    counts = masked[3]
    assert counts["mask/decoder_fused_batches"] == 0


def test_written_masks_are_the_reference_generators(masked):
    """The reference's filters, NMS and union on the same decoder outputs
    give the written masks, pixel for pixel."""
    seq, out, kept, counts = masked
    _, gen, _ = reference()
    g = dict(pred_iou_thresh=0.88, stability_score_thresh=0.95, stability_score_offset=1.0,
             box_nms_thresh=0.7, union_share=0.5, image_size=160)
    total = 0
    for f in range(3):
        low = torch.cat([kept[16 * f + b][0] for b in range(16)])
        iou = torch.cat([kept[16 * f + b][1] for b in range(16)])
        inside = imread(f"{seq}_epipolar/{f:05d}_open.png") > 127
        union, _, c = gen.select(low, iou, (64, 96), inside, g)
        assert np.array_equal(imread(f"{out}/{f:05d}.png") > 127, union)
        total += c["kept_union"]
    assert total == counts["mask/kept_union"]


def test_telemetry_phases_and_stamps(masked):
    tel = profiling.current()
    for name in ("prep_mask", "prep_mask/load", "prep_mask/select", "prep_mask/write"):
        assert tel.phase_calls[name] >= 1, name
    assert tel.phase_parent["prep_mask/select"] == "prep_mask"
    for name in ("mask/encode", "mask/decode", "mask/post"):
        assert tel.phase_seconds[name] > 0, name
    assert tel.phase_calls["mask/decode"] >= 3 * 16 and "counters" in tel.summary()


def test_cli_with_a_checkpoint(tmp_path):
    seq = make_sequence(tmp_path, n_frames=2, W=96, H=64)
    ckpt = tmp_path / "sam_tiny.pth"
    torch.save(scaled_weights(1), ckpt)
    argv = sys.argv
    sys.argv = ["prep_mask", "--img-dir", str(seq), "--checkpoint", str(ckpt), "--device", "cpu"]
    try:
        runpy.run_module("gflow_tpu_torch.cli.prep_mask", run_name="__main__")
    finally:
        sys.argv = argv
    out = str(seq) + "_mask"
    assert sorted(os.listdir(out)) == ["00000.png", "00001.png", "telemetry.json"]


def test_generator_settings(tmp_path):
    """main's generator overrides SAM's defaults by name: a grid that
    leaves a short last batch is decoded whole; an unknown name, crops or
    small-region removal are refused."""
    assert prep_mask.settings() == prep_mask.GENERATOR
    assert prep_mask.settings({"box_nms_thresh": 0.5})["box_nms_thresh"] == 0.5
    for bad in ({"points_per_sides": 8}, {"crop_n_layers": 1}, {"min_mask_region_area": 9}):
        with pytest.raises(ValueError):
            prep_mask.settings(bad)
    seq = make_sequence(tmp_path, n_frames=1, W=96, H=64)
    tel = profiling.current()
    before = tel.counters.get("mask/prompts", 0)
    seen = []
    dec = prep_mask.decode
    prep_mask.decode = lambda m, e, p, d: seen.append(len(p)) or dec(m, e, p, d)
    try:
        prep_mask.main(seq, device="cpu", model=model(),
                       generator={"points_per_side": 4, "points_per_batch": 6})
    finally:
        prep_mask.decode = dec
    assert seen == [6, 6, 4] and tel.counters["mask/prompts"] - before == 16
    assert os.path.exists(f"{seq}_mask/00000.png")


def test_no_checkpoint_no_masks(tmp_path, monkeypatch):
    monkeypatch.delenv(prep_mask.CKPT_ENV, raising=False)
    with pytest.raises(FileNotFoundError):
        prep_mask.main(tmp_path, device="cpu")


def test_fit_video_reads_the_masks(masked, tmp_path):
    """fit_video on the masked sequence finds the masks and picks the
    object's Gaussians from the first (the trainer's propagated mask
    written)."""
    from gflow_tpu_torch.core.io import list_sequence_files
    from gflow_tpu_torch.pipeline.fit_video import main as fit_main

    seq, out, _, _ = masked
    assert len(list_sequence_files(seq, frame_range=3)["masks"]) == 3
    tr = fit_main(sequence_path=seq, logs_suffix=str(tmp_path / "logs"), device="cpu",
                  num_points=300, iterations_first=4, iterations_after=2, frame_range=2,
                  traj_num=0)
    assert tr.mask_prompt_pts is not None and len(tr.mask_prompt_pts) >= 300
    assert os.path.exists(os.path.join(tr.dir, "images_seg", "propagate_mask_00000.png"))
