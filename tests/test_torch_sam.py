"""Segment Anything in the port (gflow_tpu_torch/models/sam) against the
benchmark's plain reference (bench_h100/reference/sam, written from the
published description, loaded by path), on the CPU at a tiny size with
seeded weights in the released layout: the image embedding, the decoder's
low-resolution logits and IoUs, the relative-position indexing, the
windows over a padded grid whose padded tokens enter as keys, and the key
manifest. Also the attention shared with MASt3R (models/attention.py):
MASt3R's outputs are bitwise those of its frozen copy from before the
move (bench_h100/reference/prep/vit.py).

No JAX here: SAM has no counterpart in the JAX package."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gflow_tpu_torch.models.attention import attend
from gflow_tpu_torch.models.mast3r import Mast3rConfig, Mast3rModel
from gflow_tpu_torch.models.random_weights import seeded_state_dict
from gflow_tpu_torch.models.sam import SamConfig, SamModel, convert, image_encoder

ROOT = Path(__file__).resolve().parent.parent
# a tiny encoder: 64 wide, 4 blocks of 4 heads, 4x4 windows, global
# blocks 1 and 3, a 160 input (10x10 tokens, padded to 12x12 in the windows);
# the decoder 64 wide with its released 8 heads
TINY = SamConfig(encoder_embed_dim=64, encoder_depth=4, encoder_num_heads=4,
                 encoder_global_attn_indexes=(1, 3), window_size=4, image_size=160,
                 prompt_embed_dim=64, decoder_mlp_dim=128, iou_head_hidden_dim=64)
# float32 in both, the same operations in another order (the port sums
# q k^T into the bias in the GEMM, the reference adds the bias's two parts
# after it; the einsums and the products group differently): each
# block rounds ~1e-7 apart, carried through the blocks and the neck's
# LayerNorm; 1e-5 of the largest value leaves ~20x room over what seeded
# runs read (~5e-7) and fails a wrong index, mask or width by far more
RTOL = 1e-5


def load_package(name: str, path: Path):
    """A directory of the benchmark loaded as a package by path (it is no
    import path of the tests)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path / "__init__.py",
                                                  submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference():
    load_package("_ref_sam", ROOT / "bench_h100" / "reference" / "sam")
    import _ref_sam.generator as gen
    import _ref_sam.model as ref
    import _ref_sam.shapes as shapes
    return ref, gen, shapes


def weights(cfg=TINY, seed=0, scale=1.0):
    sd = seeded_state_dict(convert.expected_torch_keys(cfg), seed, scale)
    key = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    sd[key] = torch.randn(sd[key].shape, generator=torch.Generator().manual_seed(seed + 1))
    return sd


def model_and_weights(seed=0, scale=1.0):
    sd = weights(seed=seed, scale=scale)
    m = SamModel(TINY)
    m.load_state_dict(sd, strict=True)
    return m.eval(), sd


def frame(seed=0, H=64, W=96):
    g = torch.Generator().manual_seed(seed + 100)
    return (torch.rand(H, W, 3, generator=g) * 255).to(torch.uint8)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_keys_are_the_released_layout():
    """The model's keys and shapes are the manifest written from the
    published layout, for ViT-H (sam_vit_h_4b8939: 594 tensors, 641.1 M
    values) and the tiny model; the configuration read back from the keys
    is the one they came from."""
    for cfg in (SamConfig(), TINY):
        with torch.device("meta"):
            m = SamModel(cfg)
        want = convert.expected_torch_keys(cfg)
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
        meta = {k: torch.empty(s, device="meta") for k, s in want.items()}
        assert convert.config_for_state_dict(meta) == cfg
    vith = convert.expected_torch_keys()
    assert len(vith) == 594 and sum(np.prod(s) for s in vith.values()) == 641_090_864
    assert vith["image_encoder.blocks.0.attn.rel_pos_h"] == (27, 80)
    assert vith["image_encoder.blocks.7.attn.rel_pos_w"] == (127, 80)
    assert vith["mask_decoder.transformer.layers.0.cross_attn_token_to_image.q_proj.weight"] \
        == (128, 256)
    _, _, shapes = reference()
    assert shapes.state_shapes(dataclasses.asdict(SamConfig())) == vith


def test_released_checkpoint_loads(tmp_path):
    """A checkpoint saved as upstream saves it (a plain state dict) loads
    strictly, sized from its keys."""
    sd = weights(seed=3)
    path = tmp_path / "sam_tiny.pth"
    torch.save(sd, path)
    loaded = convert.load_weights(path)
    m = SamModel(convert.config_for_state_dict(loaded))
    m.load_state_dict(loaded, strict=True)
    assert m.config == TINY


@pytest.mark.parametrize("seed", [0, 1])
def test_embedding_matches_the_reference(seed):
    ref, _, _ = reference()
    m, sd = model_and_weights(seed)
    f = frame(seed)
    with torch.no_grad():
        got = m.encode(f)
        want = ref.embed(dataclasses.asdict(TINY), sd, f)
    assert got.shape == (1, 64, 10, 10)
    assert rel(got, want) < RTOL


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_the_reference(seed):
    """Low-resolution logits and IoUs of a batch of grid prompts, from the
    reference's embedding: same relative tolerance (the IoU relative to
    its largest)."""
    ref, gen, _ = reference()
    m, sd = model_and_weights(seed)
    f = frame(seed)
    cfg = dataclasses.asdict(TINY)
    pts = torch.from_numpy(gen.grid_points(4, (64, 96), 160))
    with torch.no_grad():
        emb = ref.embed(cfg, sd, f)
        low, iou = m.decode(emb, pts[:, None], torch.ones(16, 1, dtype=torch.int64))
        want_low, want_iou = ref.decode(cfg, sd, emb, pts[:, None])
    assert low.shape == (16, 3, 40, 40) and iou.shape == (16, 3)
    assert rel(low, want_low) < RTOL and rel(iou, want_iou) < RTOL


def test_input_size_and_postprocess_crop():
    """854x480 -> 1024x576 (upstream's int(x + 0.5)); the logits go back
    through the padded square, cropped to the resized frame."""
    from gflow_tpu_torch.models.sam import input_size, postprocess_masks

    assert input_size(480, 854, 1024) == (576, 1024) and input_size(64, 96, 160) == (107, 160)
    low = torch.zeros(1, 1, 40, 40)
    low[..., 27:, :] = 5.0  # below the resized frame (107 of 160 rows): padding only
    out = postprocess_masks(low, (107, 160), (64, 96), 160)
    assert out.shape == (1, 1, 64, 96) and float(out.max()) < 5.0
    assert float(out[..., :50, :].abs().max()) == 0.0


def test_relative_position_index():
    """Row i - k + size - 1 of the table for query i and key k, and the
    bias rel_h[i, j, k] + rel_w[i, j, l] against a loop over every query
    and key."""
    r = image_encoder.rel_index(3)
    assert r.tolist() == [[2, 1, 0], [3, 2, 1], [4, 3, 2]]
    g = torch.Generator().manual_seed(0)
    h, w, D = 3, 4, 5
    q = torch.randn(2, h * w, 2, D, generator=g)
    th, tw = torch.randn(2 * h - 1, D, generator=g), torch.randn(2 * w - 1, D, generator=g)
    bias = image_encoder.rel_pos_bias(q, th, tw, h, w)
    want = torch.zeros(2, 2, h * w, h * w)
    for b in range(2):
        for n in range(2):
            for i in range(h):
                for j in range(w):
                    for k in range(h):
                        for l in range(w):
                            qv = q[b, i * w + j, n]
                            want[b, n, i * w + j, k * w + l] = (qv @ th[i - k + h - 1]
                                                                + qv @ tw[j - l + w - 1])
    assert torch.allclose(bias, want, atol=1e-5)


def test_windows_pad_and_their_padded_keys_are_not_masked():
    """A windowed block over a 10x10 grid with windows of 4 pads to 12x12:
    its attention equals one over each padded window with the zero tokens
    as keys (a loop over windows), and differs from one with them masked
    out."""
    torch.manual_seed(0)
    blk = image_encoder.Block(16, 2, 4, 4, 10).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.1 * torch.randn_like(p))
        x = torch.randn(1, 10, 10, 16)
        got = blk(x)
        y = F.pad(blk.norm1(x), (0, 0, 0, 2, 0, 2))
        att = torch.zeros(1, 12, 12, 16)
        masked = torch.zeros(1, 12, 12, 16)
        for a in range(3):
            for b in range(3):
                win = y[:, 4 * a:4 * a + 4, 4 * b:4 * b + 4]
                att[:, 4 * a:4 * a + 4, 4 * b:4 * b + 4] = blk.attn(win)
                real = torch.zeros(4, 4, dtype=torch.bool)
                real[:max(0, min(4, 10 - 4 * a)), :max(0, min(4, 10 - 4 * b))] = True
                masked[:, 4 * a:4 * a + 4, 4 * b:4 * b + 4] = _attn_masked(blk.attn, win, real)
        want = x + att[:, :10, :10]
        want = want + blk.mlp(blk.norm2(want))
        other = x + masked[:, :10, :10]
        other = other + blk.mlp(blk.norm2(other))
    assert torch.allclose(got, want, atol=1e-5)
    assert float((got - other).abs().max()) > 1e-3


def _attn_masked(attn, x, real):
    """attn on one window with the keys outside `real` left out."""
    B, h, w, C = x.shape
    q, k, v = attn.qkv(x).reshape(B, h * w, 3, attn.heads, C // attn.heads).unbind(2)
    bias = image_encoder.rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, h, w)
    bias = bias.masked_fill(~real.reshape(-1), float("-inf"))
    return attn.proj(attend(q, k, v, bias).reshape(B, h, w, C))


@pytest.mark.parametrize("with_bias", [False, True])
def test_attend_adds_the_bias_after_scaling(with_bias):
    """softmax(q k^T / sqrt(D) + bias) v; with a bias (SAM's encoder) q is
    scaled before the product, as upstream, and the bias is consumed."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 3, 4, generator=g) for _ in range(3))
    bias = torch.randn(2, 3, 5, 5, generator=g) if with_bias else torch.zeros(2, 3, 5, 5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0 + bias
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(2, 5, 12)
    got = attend(q, k, v, bias.clone() if with_bias else None)
    assert torch.allclose(got, want, atol=1e-6)
    if with_bias:
        scores = torch.einsum("bqhd,bkhd->bhqk", q / 2.0, k) + bias
        assert torch.equal(got, attend(q, k, v, bias)) and torch.allclose(bias, scores, atol=1e-6)


def test_mast3r_is_bitwise_its_frozen_copy():
    """MASt3R on the shared attend: bitwise the outputs of its copy frozen
    before the move (the benchmark's reference of the prep cell)."""
    load_package("_ref_prep", ROOT / "bench_h100" / "reference" / "prep")
    import _ref_prep.vit as frozen

    cfg = dict(enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=24, dec_depth=2, dec_heads=2,
               desc_dim=6, head="catmlp+dpt")
    port, old = Mast3rModel(Mast3rConfig(**cfg)), frozen.Mast3rModel(frozen.Mast3rConfig(**cfg))
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, 5, 0.3)
    port.load_state_dict(sd, strict=True)
    old.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(6)
    a, b = torch.rand(1, 32, 48, 3, generator=g), torch.rand(1, 32, 48, 3, generator=g)
    with torch.no_grad():
        got, want = port.eval()(a, b), old.eval()(a, b)
    for o1, o2 in zip(got, want):
        assert o1.keys() == o2.keys()
        for key in o1:
            assert torch.equal(o1[key], o2[key]), key
