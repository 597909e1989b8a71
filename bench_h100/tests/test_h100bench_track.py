"""The video mask prior's cell (``track-davis480-sam2l-obj3``) at a tiny size
on the CPU: whole runs through ``run_cell(device="cpu")`` report the
cell's end-to-end and per-layer metrics and read ``correct`` on a sound
program; each fault planted in the timed path turns ``correct`` false; the
work's counts from shapes. Marked ``cuda``: the TF32 control fails the
cell's limits where the program passes them, at the cell's own widths."""
import tempfile

import pytest
import torch

from harness import manifest

CELL = "track-davis480-sam2l-obj3"
TRAFFIC = {"width": 96, "height": 64, "object_side": 24, "object_radius_x": 16,
           "object_radius_y": 8, "period": 6}
# a tiny SAM 2 (tests/test_torch_sam2.py's): four stages, q-pooling, one
# global block, a bank of 3 memories and 4 pointers
CONFIG = {"sam2": {"embed_dim": 16, "num_heads": 1, "stages": [1, 2, 2, 1],
                   "global_att_blocks": [4], "window_spec": [8, 4, 4, 2],
                   "window_pos_embed_bkg_spatial_size": [3, 3], "d_model": 32,
                   "image_size": 128, "memattn_layers": 2, "memattn_ffn": 64, "mem_dim": 8,
                   "num_maskmem": 3, "max_obj_ptrs_in_encoder": 4, "prompt_embed_dim": 32,
                   "decoder_mlp_dim": 64, "iou_head_hidden_dim": 32},
          "sequence_frames": 6}


def tiny_run(trace=False, seed=2 ** 31 + 13, info=False):
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
    assert list(rec["checks"]) == ["feat_rel_gap", "memattn_rel_gap", "logit_rel_gap", "iou_gap",
                                   "obj_score_gap", "memory_rel_gap", "bank_mismatch",
                                   "mask_flip_share", "mask_files_missing"]
    # the window's counters (the warm sequence's left out)
    c, n = info["counters"], info["sequences"]
    assert c["track/objects"] == c["track/obj_present"] == 3 * 6 * n
    # frames 1-5 attend 1, 2, 3, 3, 3 memories and 1, 2, 3, 4, 4 pointers of 4 tokens
    assert c["track/memory_frames"] == 12 * n and c["track/ptr_tokens"] == 4 * 14 * n


def test_traced_run_reads_the_programs_stamps_and_phases():
    rec = tiny_run(trace=True)
    assert rec["correct"] is True
    names = {m["name"] for m in manifest.metrics_of(manifest.benchmark(), CELL, True)}
    assert {n for n in names if n.startswith("track.")} == {
        "track.encode_ms_per_frame", "track.memattn_ms_per_frame", "track.decode_ms_per_frame",
        "track.memenc_ms_per_frame", "track.host_s_per_frame", "track.encoder_mfu",
        "track.memattn_mfu"}
    # the CPU has no device trace: prep.idle_share finds nothing to read
    assert set(rec["metrics"]) == names - {"prep.idle_share"}
    assert all(rec["metrics"][m]["value"] > 0 for m in rec["metrics"])


def _wrong_temporal_slot(monkeypatch):
    """The tracked memories take the temporal encoding one slot off."""
    from gflow_tpu_torch.models.sam2 import MemoryBank

    orig = MemoryBank.select

    def select(self, f):
        sel = orig(self, f)
        sel["tpos"][1:] = (sel["tpos"][1:] + 1) % (self.M - 1)
        return sel

    monkeypatch.setattr(MemoryBank, "select", select)


def _rope_on_the_pointers(monkeypatch):
    """The cross attention rotates the pointer tokens too (by the table's
    first rows)."""
    from gflow_tpu_torch.models.sam2 import memory

    def forward(self, q, k, v, cos, sin, num_k_exclude_rope=0):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, -1)
        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        n, p = k.shape[1] - num_k_exclude_rope, num_k_exclude_rope
        k = torch.cat([memory.rope(k[:, :n], cos, sin)]
                      + ([memory.rope(k[:, n:], cos[:p], sin[:p])] if p else []), dim=1)
        return self.out_proj(memory.attend(memory.rope(q, cos, sin), k, v))

    monkeypatch.setattr(memory.RoPEAttention, "forward", forward)


def _stale_memory(monkeypatch):
    """Frame 2's memory never written into the bank: its slot keeps the
    memory before it, under frame 2's name."""
    from gflow_tpu_torch.models.sam2 import MemoryBank

    orig = MemoryBank.store

    def store(self, t, memory, pointer):
        orig(self, t, self.mem[:, self.mem_slot(t)].clone() if t == 2 else memory, pointer)

    monkeypatch.setattr(MemoryBank, "store", store)


def _objects_swapped(monkeypatch):
    """The decoder takes the first two objects' conditioned images in each
    other's place."""
    from gflow_tpu_torch.models.sam2 import Sam2Model

    orig = Sam2Model.heads

    def heads(self, cond, *a):
        return orig(self, torch.cat([cond[1:2], cond[:1], cond[2:]]), *a)

    monkeypatch.setattr(Sam2Model, "heads", heads)


def _first_block_own_window(monkeypatch):
    """Each stage's first block attends within its own stage's window, not
    the previous stage's."""
    from gflow_tpu_torch.models.sam2 import hiera

    orig = hiera.block_plan

    def plan(c):
        blocks, ends = orig(c)
        starts = {e + 1: i + 1 for i, e in enumerate(ends[:-1])}
        return [b[:4] + ((0 if i in c.global_att_blocks else c.window_spec[starts[i]])
                         if i in starts else b[4],) for i, b in enumerate(blocks)], ends

    monkeypatch.setattr(hiera, "block_plan", plan)


def _tf32_rounded_logits(monkeypatch):
    """The decoder's logits rounded to TF32's 10-bit mantissa."""
    from gflow_tpu_torch.models.sam2 import Sam2Model

    orig = Sam2Model.heads

    def heads(self, *a):
        masks, *rest = orig(self, *a)
        return ((masks.view(torch.int32) & ~0x1FFF).view(torch.float32), *rest)

    monkeypatch.setattr(Sam2Model, "heads", heads)


FAULTS = [_wrong_temporal_slot, _rope_on_the_pointers, _stale_memory, _objects_swapped,
          _first_block_own_window, _tf32_rounded_logits]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    rec = tiny_run()
    assert rec["correct"] is False
    assert any(c["value"] > c["limit"] for c in rec["checks"].values())


def test_work_counts_from_shapes():
    """SAM 2.1 Hiera-L at 1024: the encoder ~1.82 TFLOP a frame; the
    memory attention of 3 objects over a full bank (7 x 4096 memory tokens
    and 64 pointer tokens) ~1.82 TFLOP a frame, less while the bank fills."""
    from work import sam2_work

    cfg = manifest.config("davis480-sam2.1-hiera-l")
    w = sam2_work.sequence_work(cfg, manifest.workload(CELL)["traffic"])
    assert 1.80e12 < w["encode_flops"] < 1.84e12
    assert 1.80e12 < w["memattn_steady_flops"] < 1.84e12
    assert 22 * 1.4e12 < w["memattn_flops"] < 23 * w["memattn_steady_flops"]


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    """At the cell's widths on a short sequence: the program within every
    limit, the TF32 control above at least one."""
    import run as bench_run
    from harness.trace import Tracer

    wl = manifest.workload(CELL)
    cfg = bench_run._merged(manifest.config(wl["config"]), {"sequence_frames": 18})
    driver = manifest.module("drivers", wl["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        run = bench_run.Run(CELL, cfg, wl["traffic"], wl["check"], 2 ** 31 + 23, card, 1, tmp)
        s = driver.setup(run)
        driver.window(s, run, 1.0, Tracer(False))
        material = driver.release(s)
        limits = wl["check"]["limits"]
        program = driver.numbers(material, run)
        control = driver.numbers(material, run, wl["check"]["control"])
    assert all(program[k] <= limits[k] for k in program), (program, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)
