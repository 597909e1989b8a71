"""SAM 2 in the port (gflow_tpu_torch/models/sam2, pipeline/prep_track) against
the benchmark's plain reference (bench_h100/reference/sam2, written from
the published modules, loaded by path), on the CPU at a tiny size with
seeded weights in the released layout: Hiera's windows (a stage's first
block keeping the previous stage's), its pooled queries and a global
block; the positional embedding's interpolation and tiling; RoPE with the
key table repeated per memory frame and the pointer tokens left out; the
memory encoder; the decoder's high-resolution skips and object score; a
10-frame propagation of 2 objects, free-running, whose banks, choices and
written masks are the reference's; and the key manifest of SAM 2.1
Hiera-L.

No JAX here: SAM 2 has no counterpart in the JAX package."""
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.sam2 import MemoryBank, Sam2Config, Sam2Model, attended, convert
from gflow_tpu_torch.models.sam2.hiera import block_plan
from gflow_tpu_torch.models.sam2.memory import RoPEAttention, rope_tables
from gflow_tpu_torch.pipeline import prep_track

ROOT = Path(__file__).resolve().parent.parent
# a tiny SAM 2: a 16-wide Hiera of four stages (1, 2, 2, 1 blocks) at a
# 128 input (32 x 32 tokens, pooled to 16, 8, 4), windows 8 / 4 / 4 / 2 so
# that each stage's first block keeps the previous stage's, block 4
# global; a 32-wide neck, memory attention and decoder; a bank of the
# prompted frame and 2 more memories, 4 pointers
TINY = Sam2Config(embed_dim=16, num_heads=1, stages=(1, 2, 2, 1), global_att_blocks=(4,),
                  window_spec=(8, 4, 4, 2), window_pos_embed_bkg_spatial_size=(3, 3),
                  d_model=32, image_size=128, memattn_layers=2, memattn_ffn=64, mem_dim=8,
                  num_maskmem=3, max_obj_ptrs_in_encoder=4, prompt_embed_dim=32,
                  decoder_mlp_dim=64, iou_head_hidden_dim=32)
CFG = dataclasses.asdict(TINY)
# float32 in both; the port groups some operations otherwise (RoPE as real
# pairs where the reference multiplies complex numbers; attention through
# the shared matmul path), ~1e-7 a step carried through the blocks: 1e-5 of
# the largest value leaves ~20x room over what seeded runs read and fails
# a wrong window, table, slot or skip by far more
RTOL = 1e-5


def load_package(name: str, path: Path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path / "__init__.py",
                                                  submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference():
    load_package("_ref_sam2", ROOT / "bench_h100" / "reference" / "sam2")
    import _ref_sam2.model as ref
    import _ref_sam2.shapes as shapes
    return ref, shapes


def weights(seed=0, present=1.0):
    """Seeded released-layout weights; the Fourier features' matrix standard
    normal, the layer scales uniform in [0, 1) (the seeded spread makes
    them 0, which would skip the ConvNeXt blocks), the object-score head's
    output bias `present` (its sign sets whether the objects read present)."""
    sd = seeded_state_dict(convert.expected_torch_keys(TINY), seed, 1.0)
    g = torch.Generator().manual_seed(seed + 1)
    key = "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    sd[key] = torch.randn(sd[key].shape, generator=g)
    for k in sd:
        if k.endswith(".gamma"):
            sd[k] = torch.rand(sd[k].shape, generator=g)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"] = torch.full((1,), present)
    return sd


def model_and_weights(seed=0, present=1.0):
    sd = weights(seed, present)
    m = Sam2Model(TINY)
    m.load_state_dict(sd, strict=True)
    return m.eval(), sd


def frame(seed=0, H=48, W=72):
    g = torch.Generator().manual_seed(seed + 100)
    return (torch.rand(H, W, 3, generator=g) * 255).to(torch.uint8)


def objects(H=48, W=72):
    o = np.zeros((2, H, W), bool)
    o[0, 8:30, 10:50] = True
    o[1, 26:46, 40:70] = True
    return o


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


RELEASED = {  # sam2.1_hiera_large.pt's "model": names and shapes
    "image_encoder.trunk.pos_embed": (1, 144, 7, 7),
    "image_encoder.trunk.pos_embed_window": (1, 144, 8, 8),
    "image_encoder.trunk.patch_embed.proj.weight": (144, 3, 7, 7),
    "image_encoder.trunk.blocks.2.proj.weight": (288, 144),
    "image_encoder.trunk.blocks.2.attn.qkv.weight": (864, 144),
    "image_encoder.trunk.blocks.44.proj.weight": (1152, 576),
    "image_encoder.trunk.blocks.47.mlp.layers.1.weight": (1152, 4608),
    "image_encoder.neck.convs.0.conv.weight": (256, 1152, 1, 1),
    "image_encoder.neck.convs.3.conv.weight": (256, 144, 1, 1),
    "mask_downsample.weight": (1, 1, 4, 4),
    "memory_attention.layers.3.cross_attn_image.k_proj.weight": (256, 64),
    "memory_attention.layers.0.self_attn.q_proj.weight": (256, 256),
    "memory_attention.layers.0.linear1.weight": (2048, 256),
    "memory_attention.norm.weight": (256,),
    "memory_encoder.mask_downsampler.encoder.0.weight": (4, 1, 3, 3),
    "memory_encoder.mask_downsampler.encoder.10.weight": (256,),
    "memory_encoder.mask_downsampler.encoder.12.weight": (256, 256, 1, 1),
    "memory_encoder.pix_feat_proj.weight": (256, 256, 1, 1),
    "memory_encoder.fuser.layers.1.dwconv.weight": (256, 1, 7, 7),
    "memory_encoder.fuser.layers.0.gamma": (256,),
    "memory_encoder.out_proj.weight": (64, 256, 1, 1),
    "maskmem_tpos_enc": (7, 1, 1, 64),
    "no_mem_embed": (1, 1, 256), "no_mem_pos_enc": (1, 1, 256), "no_obj_ptr": (1, 256),
    "no_obj_embed_spatial": (1, 64),
    "obj_ptr_proj.layers.2.weight": (256, 256),
    "obj_ptr_tpos_proj.weight": (64, 256),
    "sam_prompt_encoder.mask_downscaling.0.weight": (4, 1, 2, 2),
    "sam_mask_decoder.obj_score_token.weight": (1, 256),
    "sam_mask_decoder.conv_s0.weight": (32, 256, 1, 1),
    "sam_mask_decoder.conv_s1.weight": (64, 256, 1, 1),
    "sam_mask_decoder.pred_obj_score_head.layers.2.weight": (1, 256),
    "sam_mask_decoder.iou_prediction_head.layers.2.weight": (4, 256),
}


def test_keys_are_the_released_layout():
    """SAM 2.1 Hiera-L's manifest: 224.4 M values, the released names and
    shapes above, the model's own keys, the reference's independently
    written layout; the configuration read back from the keys is Hiera-L."""
    _, shapes = reference()
    for cfg in (Sam2Config(), TINY):
        with torch.device("meta"):
            m = Sam2Model(cfg)
        want = convert.expected_torch_keys(cfg)
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
        assert shapes.state_shapes(dataclasses.asdict(cfg)) == want
    large = convert.expected_torch_keys()
    assert len(large) == 903 and sum(np.prod(s) for s in large.values()) == 224_446_898
    assert {k: large[k] for k in RELEASED} == RELEASED
    meta = {k: torch.empty(s, device="meta") for k, s in large.items()}
    assert convert.config_for_state_dict(meta) == Sam2Config()


def test_released_checkpoint_loads(tmp_path):
    """A checkpoint saved as upstream saves it (the state dict under
    "model") loads strictly."""
    sd = weights(seed=3)
    path = tmp_path / "sam2_tiny.pt"
    torch.save({"model": sd}, path)
    loaded = prep_track.load_weights(str(path))
    m = Sam2Model(TINY)
    m.load_state_dict(loaded, strict=True)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_hiera_windows_lag_a_block_and_pool_the_first():
    """Hiera-L's blocks: each stage's first block keeps the previous stage's
    window, pools its queries and doubles width and heads; blocks 23, 33
    and 43 global; as the reference lays them out."""
    ref, _ = reference()
    plan, ends = block_plan(Sam2Config())
    assert ends == [1, 7, 43, 47]
    windows = [p[4] for p in plan]
    assert windows[:3] == [8, 8, 8] and windows[3:9] == [4] * 6
    assert windows[9:23] == [16] * 14 and windows[23] == windows[33] == windows[43] == 0
    assert windows[44:] == [16, 8, 8, 8]
    assert [i for i, p in enumerate(plan) if p[3]] == [2, 8, 44]
    assert plan[2][:3] == (144, 288, 4) and plan[8][:3] == (288, 576, 8)
    assert plan[44][:3] == (576, 1152, 16)
    assert ref.stage_layout(dataclasses.asdict(Sam2Config())) == (plan, ends)
    tiny, _ = block_plan(TINY)
    assert [p[4] for p in tiny] == [8, 8, 4, 4, 0, 4] and [p[3] for p in tiny] == [0, 2, 0, 2, 0, 2]


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_matches_the_reference(seed):
    """The three FPN levels (the two finer through conv_s0 / conv_s1)."""
    ref, _ = reference()
    m, sd = model_and_weights(seed)
    f = frame(seed)
    with torch.no_grad():
        s0, s1, feat = m.encode(f)
        want = ref.encode(CFG, sd, f)
    assert s0.shape == (1, 4, 32, 32) and s1.shape == (1, 8, 16, 16)
    assert feat.shape == (1, 32, 8, 8)
    for got, w in ((s0, want["s0"]), (s1, want["s1"]), (feat, want["feat"])):
        assert rel(got, w) < RTOL


def test_pos_embed_interpolation_and_tiling():
    """The background table bicubic to the grid plus the window table tiled
    over it, at Hiera-L's 7 -> 256 and the tiny 3 -> 32."""
    ref, _ = reference()
    g = torch.Generator().manual_seed(5)
    for c, n in ((Sam2Config(), 256), (TINY, 32)):
        m = Sam2Model(c) if c is TINY else None
        trunk = m.image_encoder.trunk if m else None
        if trunk is None:
            from gflow_tpu_torch.models.sam2.hiera import Hiera
            with torch.device("meta"):
                trunk = Hiera(c)
            trunk = trunk.to_empty(device="cpu")
        with torch.no_grad():
            trunk.pos_embed.copy_(torch.randn(trunk.pos_embed.shape, generator=g))
            trunk.pos_embed_window.copy_(torch.randn(trunk.pos_embed_window.shape, generator=g))
            sd = {"image_encoder.trunk.pos_embed": trunk.pos_embed,
                  "image_encoder.trunk.pos_embed_window": trunk.pos_embed_window}
            got = trunk.pos(n, n)
            want = ref.hiera_pos_embed(sd, (n, n))
        w = c.window_spec[0]
        assert got.shape == (1, n, n, c.embed_dim) and torch.equal(got, want)
        # the window table repeats every w tokens on top of a smooth field
        d = got[0, w:2 * w, :w] - got[0, :w, :w]
        assert float(d.abs().max()) < float(got.abs().max())


@pytest.mark.parametrize("blocks", [1, 5])
def test_rope_repeats_per_memory_frame_and_leaves_the_pointers_out(blocks, monkeypatch):
    """The cross attention over 2 memory frames of 8 x 8 tokens and 3
    pointer tokens against upstream's complex-product RoPE, its queries in
    one block or in 5 (the score blocks' bound); each memory frame's keys
    take the same table (not the rows after it), and the pointer tokens
    none."""
    from gflow_tpu_torch.models.sam2 import memory
    from gflow_tpu_torch.models.sam2.memory import rope

    if blocks > 1:  # 13 query rows a block of 2 x 131 keys
        monkeypatch.setattr(memory, "SCORE_BLOCK_BYTES", 4 * 2 * 131 * 13)

    ref, _ = reference()
    g = torch.Generator().manual_seed(7)
    attn = RoPEAttention(32, 1, 8)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    sd = {f"a.{k}": v for k, v in attn.state_dict().items()}
    q = torch.randn(2, 64, 32, generator=g)
    k = torch.randn(2, 2 * 64 + 3, 8, generator=g)
    v = torch.randn(2, 2 * 64 + 3, 8, generator=g)
    cos, sin = rope_tables(32, 8, 8)
    freqs = ref.compute_axial_cis(32, 8, 8)
    assert torch.allclose(torch.complex(cos, sin), freqs, atol=1e-6)
    with torch.no_grad():
        got = attn(q, k, v, cos, sin, 3)
        want = ref.rope_attention({"memattn_heads": 1}, sd, "a", q, k, v, freqs, True, 3)
        assert rel(got, want) < RTOL
        x = torch.randn(1, 128, 1, 32, generator=g)
        two = rope(x, cos, sin)
        assert torch.equal(two[:, 64:], rope(x[:, 64:], cos, sin))
        cos2, sin2 = rope_tables(32, 8, 16)
        assert rel(two, rope(x, cos2, sin2)) > 1e-2
        # the pointers, unrotated, are the projection's own
        kp = attn.k_proj(k)[:, 128:]
        kr = rope(attn.k_proj(k)[:, 128:][:, :, None], cos[:3], sin[:3])[:, :, 0]
        assert rel(kp, kr) > 1e-2


def test_memory_encoder_matches_the_reference():
    """The memory of a frame from its features and a mask's logits, present
    and absent objects, binarized (the prompted frame) or through the
    sigmoid."""
    ref, _ = reference()
    m, sd = model_and_weights(2)
    g = torch.Generator().manual_seed(8)
    feat = torch.randn(1, 32, 8, 8, generator=g)
    high = torch.randn(2, 1, 128, 128, generator=g) * 5
    score = torch.tensor([[1.5], [-0.5]])
    with torch.no_grad():
        for binarize in (True, False):
            got = m.encode_memory(feat, high, score, binarize)
            want, _ = ref.encode_memory(CFG, sd, feat.expand(2, -1, -1, -1), high, score,
                                        binarize)
            assert got.shape == (2, 64, 8)
            assert rel(got, want.flatten(2).transpose(1, 2)) < RTOL


@pytest.mark.parametrize("present", [1.0, -1.0])
def test_decoder_skips_and_object_score_match_the_reference(present):
    """A tracked frame's heads on per-object images (the high-resolution
    skips, the object-score token and head, the sigmoid IoU, the best of
    three, the pointer; absent objects at -1024 and no_obj_ptr), and the
    prompted frame's mask path (its dense prompt per cell)."""
    ref, _ = reference()
    m, sd = model_and_weights(3, present)
    g = torch.Generator().manual_seed(9)
    cond = torch.randn(2, 32, 8, 8, generator=g)
    s0 = torch.randn(1, 4, 32, 32, generator=g)
    s1 = torch.randn(1, 8, 16, 16, generator=g)
    with torch.no_grad():
        masks, iou, score, low, ptr, high = m.heads(cond, s0, s1)
        want = ref.sam_heads(CFG, sd, cond, s0.expand(2, -1, -1, -1), s1.expand(2, -1, -1, -1))
        assert (score > 0).all() == (present > 0) and (want["score"] > 0).all() == (present > 0)
        assert rel(masks, want["masks"]) < RTOL and rel(iou, want["iou"]) < RTOL
        assert rel(score, want["score"]) < RTOL and rel(ptr, want["ptr"]) < RTOL
        assert torch.equal(low == -1024.0, want["low"] == -1024.0)
        assert rel(low, want["low"]) < RTOL and rel(high, want["high"]) < RTOL
        mk = torch.from_numpy(np.pad(objects(), ((0, 0), (40, 40), (28, 28)))[:, None]).float()
        low, ptr, score, _ = m.prompt(cond[:1], s0, s1, mk)
        want = ref.use_mask_as_output(CFG, sd, cond[:1], s0, s1, mk)
    assert rel(low, want["low"]) < RTOL and rel(ptr, want["ptr"]) < RTOL
    assert torch.equal(score, want["score"])


def write_sequence(root: Path, n=10, H=48, W=72):
    seq = root / "seq"
    seq.mkdir()
    for t in range(n):
        f = frame(t, H, W).numpy()
        Image.fromarray(np.roll(f, 3 * t, axis=1)).save(seq / f"{t:05d}.png")
    ann = np.zeros((H, W), np.uint8)
    o = objects(H, W)
    ann[o[1]] = 2
    ann[o[0]] = 1
    img = Image.fromarray(ann, mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
    img.save(root / "00000.png")
    return seq, root / "00000.png"


def test_propagation_of_two_objects_is_the_references(tmp_path, monkeypatch):
    """prep_track.main over 10 frames (a bank of 3 memories and 4 pointers
    fills at frames 2 and 4, then rolls), 2 objects from a palette
    annotation, free-running, against upstream's predictor free-running:
    every frame's memory and pointer (the bank's entries), object scores,
    the frames and temporal slots it attended, and the written union."""
    import torch.nn.functional as F

    ref, _ = reference()
    m, sd = model_and_weights(4)
    seq, ann = write_sequence(tmp_path)
    got = {}
    store = MemoryBank.store

    def record(self, t, memory, pointer):
        got[t] = {"mem": memory.clone(), "ptr": pointer.clone()}
        store(self, t, memory, pointer)

    choices = {}
    sel = MemoryBank.select

    def chosen(self, f):
        s = sel(self, f)
        choices[f] = attended(s)
        return s

    monkeypatch.setattr(MemoryBank, "store", record)
    monkeypatch.setattr(MemoryBank, "select", chosen)
    out = prep_track.main(str(seq), annotation=str(ann), device="cpu", model=m)
    assert out == str(seq) + "_mask"
    frames = [torch.from_numpy(np.array(Image.open(seq / f"{t:05d}.png"))) for t in range(10)]
    o = torch.from_numpy(prep_track.read_objects(ann)).float()[:, None]
    masks = (F.interpolate(o, (128, 128), mode="bilinear", align_corners=False,
                           antialias=True) >= 0.5).float()
    with torch.no_grad():
        want = ref.propagate(CFG, sd, frames, masks)
    for t in range(10):
        w = want[t]
        assert rel(got[t]["mem"], w["mem"].flatten(2).transpose(1, 2)) < RTOL, t
        assert rel(got[t]["ptr"], w["ptr"]) < RTOL, t
        if t:
            assert choices[t] == w["choice"], t
        union = (F.interpolate(w["low"], (48, 72), mode="bilinear", align_corners=False)[:, 0]
                 > 0).any(0).numpy()
        written = np.asarray(Image.open(Path(out) / f"{t:05d}.png")) > 127
        assert (written == union).all(), t
    assert choices[9] == {"memory": [(0, 2), (7, 1), (8, 0)],
                          "pointers": [(0, 9), (6, 3), (7, 2), (8, 1)]}
    assert os.path.exists(Path(out) / "00009.png")


def test_without_weights_it_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(prep_track.CKPT_ENV, raising=False)
    seq, ann = write_sequence(tmp_path, n=1)
    with pytest.raises(FileNotFoundError, match="SAM 2 checkpoint"):
        prep_track.main(str(seq), annotation=str(ann), device="cpu")
    with pytest.raises(FileNotFoundError, match="prep_moveseg"):
        prep_track.main(str(seq), device="cpu", model=model_and_weights()[0])


def test_parts_replay_graphs_keyed_by_the_banks_fill(tmp_path, monkeypatch):
    """The card's graph path on the CPU (a fake capture): over 10 frames the
    encoder, decoder and memory encoder record one graph each (and the
    prompted frame's two), the memory attention one per fill of the bank:
    (1, 1), (2, 2), (3, 3) memories and pointers, then (3, 4) from frame 4
    on, which frames 4-9 replay; the written masks equal the eager run's."""
    from gflow_tpu_torch.opt import graphs
    from test_torch_stage_graph import FakeGraph

    m, _ = model_and_weights(5)
    seq, ann = write_sequence(tmp_path)

    def run():
        out = prep_track.main(str(seq), annotation=str(ann), device="cpu", model=m)
        return [np.asarray(Image.open(f"{out}/{t:05d}.png")) for t in range(10)]

    want = run()
    monkeypatch.setattr(graphs, "graphed", lambda dev: not graphs._eager)
    cache = graphs.ForwardCache("sam2", 32, capture=FakeGraph)
    monkeypatch.setattr(prep_track, "TRACK_GRAPHS", cache)
    FakeGraph.captures = 0
    graphs.REPLAYS.clear()
    got = run()
    assert all((a == b).all() for a, b in zip(got, want))
    fills = sorted(tuple(s[0][:2] for s in k[2][1:4:2]) for k in cache.entries
                   if "memattn" in k[0])
    assert fills == [((2, 1), (2, 1)), ((2, 2), (2, 2)), ((2, 3), (2, 3)), ((2, 3), (2, 4))]
    assert FakeGraph.captures == len(cache.entries) == 4 + 5
    assert graphs.REPLAYS["sam2"] == 10 + 1 + 9 + 9 + 10
