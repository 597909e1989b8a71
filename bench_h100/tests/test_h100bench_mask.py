"""The mask prior's cell (``mask-davis480-sam-grid32``) at a tiny size on
the CPU: whole runs through ``run_cell(device="cpu")`` report the cell's
end-to-end and per-layer metrics and read ``correct`` on a sound program;
each fault planted in the timed path turns ``correct`` false; the work's
counts from shapes. The tiny run's object covers most of the frame and its
decoder's heads are scaled, so that masks pass the filters and join the
union on the drawn frames, and a fault in the selection shows. Marked
``cuda``: the TF32 control fails the cell's limits where the program passes
them, at the cell's own widths."""
import tempfile

import pytest
import torch

from harness import manifest

CELL = "mask-davis480-sam-grid32"
TRAFFIC = {"width": 96, "height": 64, "object_side": 56, "object_radius_x": 4,
           "object_radius_y": 2, "period": 4}
CONFIG = {"sam": {"encoder_embed_dim": 64, "encoder_depth": 4, "encoder_num_heads": 4,
                  "encoder_global_attn_indexes": [1, 3], "window_size": 4, "image_size": 160,
                  "prompt_embed_dim": 64, "decoder_mlp_dim": 128, "iou_head_hidden_dim": 64},
          "weight_scale": {"image_encoder": 1.0, "prompt_encoder": 1.0, "mask_decoder": 1.0,
                           "mask_decoder.output_hypernetworks_mlps": 10.0,
                           "mask_decoder.iou_prediction_head": 4.0},
          "sequence_frames": 3}


def tiny_run(trace=False, seed=2 ** 31 + 11, info=False):
    import run as bench_run

    rec = bench_run.run_cell(CELL, seed, 1.0, trace, device="cpu", traffic_overrides=TRAFFIC,
                             config_overrides=CONFIG)
    got = rec.pop("_info")
    return (rec, got) if info else rec


def test_sound_run_is_correct_and_reports_its_metrics():
    rec, info = tiny_run(info=True)
    assert rec["correct"] is True, rec["checks"]
    bench = manifest.benchmark()
    assert set(rec["metrics"]) == {m["name"] for m in manifest.metrics_of(bench, CELL, False)} \
        == {"prep_s_per_frame", "setup_s"}
    assert list(rec["checks"]) == ["embed_rel_gap", "logit_rel_gap", "iou_gap",
                                   "mask_flip_share", "nms_kept_mismatch", "prompts_missing",
                                   "mask_files_missing"]
    # the check had masks to compare: NMS kept some and the union is not empty
    counts = info["check_counts"].values()
    assert all(c["kept_nms"] > 0 and c["kept_union"] > 0 for c in counts), counts


def test_traced_run_reads_the_programs_stamps_and_phases():
    rec = tiny_run(trace=True)
    assert rec["correct"] is True
    names = {m["name"] for m in manifest.metrics_of(manifest.benchmark(), CELL, True)}
    # the CPU has no device trace: prep.idle_share finds nothing to read
    assert set(rec["metrics"]) == names - {"prep.idle_share"}
    assert all(rec["metrics"][m]["value"] > 0 for m in rec["metrics"])


def _rel_index_off_by_one(monkeypatch):
    """The relative-position table read one row off (wrapping)."""
    from gflow_tpu_torch.models.sam import image_encoder

    orig = image_encoder.rel_index
    monkeypatch.setattr(image_encoder, "rel_index",
                        lambda size, device=None: (orig(size, device) + 1) % (2 * size - 1))


def _masked_padding(monkeypatch):
    """The windows' padded tokens masked out of the keys."""
    from gflow_tpu_torch.models.sam import image_encoder

    part, att = image_encoder.window_partition, image_encoder.attend
    pad = {}

    def partition(x, ws):
        windows, hw = part(x, ws)
        real = torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        pad["keys"] = part(real, ws)[0].reshape(windows.shape[0], 1, 1, -1) > 0
        return windows, hw

    def attend(q, k, v, bias=None):
        keys = pad.pop("keys", None)
        if keys is not None:
            bias = bias.masked_fill(~keys, float("-inf"))
        return att(q, k, v, bias)

    monkeypatch.setattr(image_encoder, "window_partition", partition)
    monkeypatch.setattr(image_encoder, "attend", attend)


def _tf32_rounded_logits(monkeypatch):
    """The decoder's logits rounded to TF32's 10-bit mantissa."""
    from gflow_tpu_torch.models.sam import SamModel

    orig = SamModel.decode

    def rounded(self, *a, **k):
        low, iou = orig(self, *a, **k)
        return (low.view(torch.int32) & ~0x1FFF).view(torch.float32), iou

    monkeypatch.setattr(SamModel, "decode", rounded)


def _dropped_batch(monkeypatch):
    """The grid's last batch of prompts never decoded: the batch before it
    decoded again in its place."""
    from gflow_tpu_torch.pipeline import prep_mask

    orig = prep_mask.point_grid

    def dropped(n, h, w):
        pts = orig(n, h, w)
        pts[-64:] = pts[-128:-64]
        return pts

    monkeypatch.setattr(prep_mask, "point_grid", dropped)


def _empty_masks_written(monkeypatch):
    """Nothing joins the union: every written mask empty."""
    from gflow_tpu_torch.pipeline import prep_mask

    orig = prep_mask.union_inside

    def empty(masks, inside, share):
        union, _ = orig(masks, inside, share)
        return torch.zeros_like(union), 0

    monkeypatch.setattr(prep_mask, "union_inside", empty)


def _nms_drops_its_last(monkeypatch):
    """NMS drops the last mask it kept."""
    from gflow_tpu_torch.pipeline import prep_mask

    orig = prep_mask.nms
    monkeypatch.setattr(prep_mask, "nms", lambda *a: orig(*a)[:-1])


def _weight_changed_in_place(monkeypatch):
    """The program changes one of its weights in place at its first encode
    (the reference has its own copy of the weights, so this shows)."""
    from gflow_tpu_torch.models.sam import SamModel

    orig = SamModel.encode
    done = set()

    def encode(self, frame):
        if id(self) not in done:
            done.add(id(self))
            with torch.no_grad():
                self.image_encoder.blocks[0].attn.proj.weight.mul_(1.01)
        return orig(self, frame)

    monkeypatch.setattr(SamModel, "encode", encode)


FAULTS = [_rel_index_off_by_one, _masked_padding, _tf32_rounded_logits, _dropped_batch,
          _empty_masks_written, _nms_drops_its_last, _weight_changed_in_place]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    rec = tiny_run()
    assert rec["correct"] is False
    assert any(c["value"] > c["limit"] for c in rec["checks"].values())


def test_work_counts_from_shapes():
    from work import sam_work

    cfg = manifest.config("davis480-sam-vith")
    w = sam_work.frame_work(cfg, manifest.workload(CELL)["traffic"])
    assert w["batches"] == 16
    # ViT-H at 1024: patch conv, 32 blocks of qkv/proj/MLP, windowed and
    # global attention with the bias einsums, the neck; the decoder at 64
    # prompts a batch
    assert 5.9e12 < w["encode_flops"] < 6.0e12 and 3.6e12 < w["decode_flops"] < 3.8e12
    masks = 64 * 3
    assert w["post_bytes"] == 16 * (masks * 256 * 256 * 4 + masks * 4 + masks * 480 * 854
                                    + masks * 16)


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    """At the cell's widths on two frames: the program within every limit,
    the TF32 control above at least one."""
    import run as bench_run
    from harness.trace import Tracer

    wl = manifest.workload(CELL)
    cfg = bench_run._merged(manifest.config(wl["config"]), {"sequence_frames": 2})
    driver = manifest.module("drivers", wl["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        run = bench_run.Run(CELL, cfg, wl["traffic"], wl["check"], 2 ** 31 + 21, card, 1, tmp)
        s = driver.setup(run)
        driver.window(s, run, 1.0, Tracer(False))
        material = driver.release(s)
        limits = wl["check"]["limits"]
        program = driver.numbers(material, run)
        control = driver.numbers(material, run, wl["check"]["control"])
    assert all(program[k] <= limits[k] for k in program), (program, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)
