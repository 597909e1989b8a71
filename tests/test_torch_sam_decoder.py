"""The image stream of SAM's mask decoder (gflow_tpu_torch/ops/sam_decoder.py)
on the CPU: each plain version, and the whole two-way transformer, against
the decoder's formula before the stream was kept as token rows (upstream's
``transformer.py``, written out below op for op) at the tiny decoder's
width and at batches of 1, 3 and 64 prompts over an 8 x 8 grid; the
kernels' wrappers refusing what the kernels do not take; the kernels'
constants against the wrappers'; and a decode at the released widths
through the kernel wrappers, their launches emulated by the plain
versions, against the plain decode.

The kernels themselves run only on the card (tests/test_torch_cuda.py).

Tolerance: the plain versions and the whole transformer run the same
float32 operations in the same order as the formula they replace, so they
agree to the last bit here; 1e-6 of the largest value leaves room for a
BLAS that blocks a strided operand another way, and fails a wrong head,
token, row or PE by orders of magnitude more."""
import re
from pathlib import Path

import pytest
import torch

from gflow_tpu_torch.models.attention import attend
from gflow_tpu_torch.models.sam import SamConfig
from gflow_tpu_torch.models.sam.decoder import MaskDecoder, PromptEncoder, TwoWayTransformer
from gflow_tpu_torch.ops import _build
from gflow_tpu_torch.ops import sam_decoder as sd

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-6
# the tiny decoder of tests/test_torch_sam.py: 64 wide, 8 heads, MLP 128,
# cross attention at 32; an 8 x 8 grid; 7 tokens (iou, 4 masks, point, pad)
DIM, HEADS, MLP, GRID, T = 64, 8, 128, 8, 7
N = GRID * GRID


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def seeded(module, seed=0, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module.eval()


def randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def grid_pe(C, seed=1):
    """A (1, C, h, w) PE laid out as the prompt encoder's (token-major)."""
    return randn(GRID, GRID, C, seed=seed).permute(2, 0, 1)[None]


# --- the formula before the image stream was kept as token rows ----------

def upstream_attention(attn, q, k, v):
    split = lambda t: t.reshape(t.shape[0], t.shape[1], attn.heads, -1)
    return attn.out_proj(attend(split(attn.q_proj(q)), split(attn.k_proj(k)),
                                split(attn.v_proj(v))))


def upstream_block(block, queries, keys, query_pe, key_pe):
    if block.skip_first_layer_pe:
        queries = upstream_attention(block.self_attn, queries, queries, queries)
    else:
        q = queries + query_pe
        queries = queries + upstream_attention(block.self_attn, q, q, queries)
    queries = block.norm1(queries)
    q, k = queries + query_pe, keys + key_pe
    queries = block.norm2(queries + upstream_attention(block.cross_attn_token_to_image,
                                                       q, k, keys))
    queries = block.norm3(queries + block.mlp(queries))
    q, k = queries + query_pe, keys + key_pe
    keys = block.norm4(keys + upstream_attention(block.cross_attn_image_to_token,
                                                 k, q, queries))
    return queries, keys


def upstream_transformer(tr, image, image_pe, tokens, dense):
    """image, image_pe (1, C, h, w), dense (C,): the embedding expanded to
    the prompts plus the dense prompt expanded to the grid, as before."""
    B = tokens.shape[0]
    _, C, h, w = image.shape
    src = image.expand(B, -1, -1, -1) + dense.reshape(1, -1, 1, 1).expand(B, -1, h, w)
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = image_pe.expand(B, -1, -1, -1).flatten(2).permute(0, 2, 1)
    queries = tokens
    for layer in tr.layers:
        queries, keys = upstream_block(layer, queries, keys, tokens, key_pe)
    q, k = queries + tokens, keys + key_pe
    queries = tr.norm_final_attn(queries + upstream_attention(tr.final_attn_token_to_image,
                                                              q, k, keys))
    return queries, keys


# --- the plain versions ----------------------------------------------------

@pytest.mark.parametrize("B", [1, 3, 64])
def test_stream_init_plain_is_the_expanded_sum(B):
    image, dense, pe = randn(1, DIM, GRID, GRID), randn(DIM, seed=2), grid_pe(DIM)
    keys, kpe = sd.stream_init(image, dense, pe[0].flatten(1).t(), B)
    src = image.expand(B, -1, -1, -1) + dense.reshape(1, -1, 1, 1).expand(B, -1, GRID, GRID)
    want = src.flatten(2).permute(0, 2, 1)
    want_pe = want + pe.expand(B, -1, -1, -1).flatten(2).permute(0, 2, 1)
    assert keys.shape == kpe.shape == (B, N, DIM)
    assert rel(keys, want) <= RTOL and rel(kpe, want_pe) <= RTOL


@pytest.mark.parametrize("B", [1, 3, 64])
def test_cross_attentions_plain_are_the_attention(B):
    """The token-to-image and image-to-token attentions of a block, through
    the module with each plain version, against the module's formula before."""
    block = seeded(TwoWayTransformer(2, DIM, HEADS, MLP, 2)).layers[1]
    tokens, keys, kpe = randn(B, T, DIM, seed=3), randn(B, N, DIM, seed=4), randn(B, N, DIM, seed=5)
    t2i, i2t = block.cross_attn_token_to_image, block.cross_attn_image_to_token
    with torch.no_grad():
        got = t2i(tokens, kpe, keys, sd.t2i_attend)
        want = upstream_attention(t2i, tokens, kpe, keys)
        assert got.shape == (B, T, DIM) and rel(got, want) <= RTOL
        got = i2t(kpe, tokens, keys[:, :T], sd.i2t_attend)
        want = upstream_attention(i2t, kpe, tokens, keys[:, :T])
        assert got.shape == (B, N, DIM) and rel(got, want) <= RTOL


@pytest.mark.parametrize("B", [1, 3, 64])
def test_residual_ln_plain_is_norm4_then_the_pe(B):
    norm = seeded(TwoWayTransformer(2, DIM, HEADS, MLP, 2)).layers[0].norm4
    keys, out, pe = randn(B, N, DIM, seed=6), randn(B, N, DIM, seed=7), randn(N, DIM, seed=8)
    with torch.no_grad():
        got, got_pe = sd.residual_ln(keys, out, norm.weight, norm.bias, norm.eps, pe)
        want = norm(keys + out)
    assert rel(got, want) <= RTOL and rel(got_pe, want + pe) <= RTOL


@pytest.mark.parametrize("B", [1, 3, 64])
def test_two_way_transformer_is_upstreams(B):
    tr = seeded(TwoWayTransformer(2, DIM, HEADS, MLP, 2), seed=B)
    image, dense, pe = randn(1, DIM, GRID, GRID, seed=9), randn(DIM, seed=10), grid_pe(DIM, 11)
    tokens = randn(B, T, DIM, seed=12)
    with torch.no_grad():
        q, k = tr(image, pe, tokens, dense)
        want_q, want_k = upstream_transformer(tr, image, pe, tokens, dense)
    assert q.shape == (B, T, DIM) and k.shape == (B, N, DIM)
    assert rel(q, want_q) <= RTOL and rel(k, want_k) <= RTOL


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def refuse(*args):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    for name in ("stream_init_kernel", "t2i_attend_kernel", "i2t_attend_kernel",
                 "residual_ln_kernel"):
        monkeypatch.setattr(sd, name, refuse)
    tr = seeded(TwoWayTransformer(2, DIM, HEADS, MLP, 2))
    with torch.no_grad():
        tr(randn(1, DIM, GRID, GRID), grid_pe(DIM), randn(2, T, DIM), randn(DIM))


# --- the kernels' wrappers ---------------------------------------------------

def cell_inputs(B=2, n=64, T=7):
    """The attentions' and the norm's inputs at the released widths."""
    return dict(q_t=randn(B, T, sd.INNER), k_n=randn(B, n, sd.INNER, seed=1),
                q_n=randn(B, n, sd.INNER, seed=2), k_t=randn(B, T, sd.INNER, seed=3),
                x=randn(B, n, sd.WIDTH, seed=4), w=randn(sd.WIDTH, seed=5),
                pe=randn(n, sd.WIDTH, seed=6))


def calls(c):
    """One good call of each wrapper, by name, as a thunk taking overrides."""
    image = randn(1, sd.WIDTH, 8, 8)
    return {
        "stream_init": lambda **o: sd.stream_init_kernel(
            o.get("image", image), o.get("dense", c["w"]), o.get("key_pe", c["pe"]), 2),
        "t2i_attend": lambda **o: sd.t2i_attend_kernel(
            o.get("q", c["q_t"]), o.get("k", c["k_n"]), o.get("v", c["k_n"]),
            o.get("heads", 8)),
        "i2t_attend": lambda **o: sd.i2t_attend_kernel(
            o.get("q", c["q_n"]), o.get("k", c["k_t"]), o.get("v", c["k_t"]),
            o.get("heads", 8)),
        "residual_ln": lambda **o: sd.residual_ln_kernel(
            o.get("keys", c["x"]), o.get("out", c["x"]), o.get("weight", c["w"]), c["w"], 1e-5,
            o.get("key_pe", c["pe"])),
    }


BAD = [  # (wrapper, argument, how it is wrong, the error's words)
    ("stream_init", "image", lambda t: t[:, :, :7, :7], "multiples"),
    ("stream_init", "image", lambda t: t.double(), "float32"),
    ("stream_init", "image", lambda t: t.transpose(2, 3), "contiguous"),
    ("stream_init", "dense", lambda t: t[:128], "shape"),
    ("stream_init", "key_pe", lambda t: t.t().contiguous().t(), "contiguous"),
    ("t2i_attend", "q", lambda t: t[:, :, :64], "shape"),
    ("t2i_attend", "q", lambda t: torch.cat([t] * 2, 1), "tokens"),
    ("t2i_attend", "k", lambda t: t.half(), "float32"),
    ("t2i_attend", "v", lambda t: t[:, ::2], "shape"),
    ("t2i_attend", "heads", lambda t: 4, "heads"),
    ("i2t_attend", "q", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     "contiguous"),
    ("i2t_attend", "k", lambda t: t[:, :0], "tokens"),
    ("i2t_attend", "v", lambda t: t[:, :3], "shape"),
    ("residual_ln", "keys", lambda t: t[..., :128], "shape"),
    ("residual_ln", "out", lambda t: t.new_zeros(t.numel() + 1)[1:].view(t.shape), "aligned"),
    ("residual_ln", "weight", lambda t: t.double(), "float32"),
    ("residual_ln", "key_pe", lambda t: t[:32], "shape"),
]


@pytest.mark.parametrize("fn,arg,bad,words", BAD, ids=[f"{f}-{a}-{w}" for f, a, _, w in BAD])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, arg, bad, words):
    c = cell_inputs()
    call = calls(c)[fn]
    good = {"stream_init": {"image": randn(1, sd.WIDTH, 8, 8), "dense": c["w"],
                            "key_pe": c["pe"]},
            "t2i_attend": {"q": c["q_t"], "k": c["k_n"], "v": c["k_n"], "heads": 8},
            "i2t_attend": {"q": c["q_n"], "k": c["k_t"], "v": c["k_t"], "heads": 8},
            "residual_ln": {"keys": c["x"], "out": c["x"], "weight": c["w"],
                            "key_pe": c["pe"]}}[fn]
    with pytest.raises(ValueError, match=words):
        call(**{arg: bad(good[arg])})


@pytest.mark.parametrize("fn", ["stream_init", "t2i_attend", "i2t_attend", "residual_ln"])
def test_wrappers_pass_good_cpu_input_to_the_launch_which_refuses_it(fn):
    """Well-formed CPU tensors pass the wrapper's checks and are refused by
    the launch itself: a kernel's tensors lie on a CUDA device."""
    with pytest.raises(ValueError, match="CUDA device"):
        calls(cell_inputs())[fn]()


def test_kernel_constants_are_the_wrappers():
    src = (ROOT / "gflow_tpu_torch" / "csrc" / "sam_decoder.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kInner"], c["kHeads"], c["kHeadDim"]) == (sd.INNER, sd.HEADS,
                                                          sd.INNER // sd.HEADS)
    assert (c["kWidth"], c["kTile"], c["kChunk"], c["kMaxT"]) == (sd.WIDTH, sd.TILE, sd.CHUNK,
                                                                  sd.MAX_TOKENS)
    assert "constexpr float kScale = 0.25f;" in src  # 1 / sqrt(16)
    for name in ("sam_stream_init", "sam_t2i_attend", "sam_i2t_attend", "sam_residual_ln"):
        source, symbol, _ = _build.KERNELS[name]
        assert source == "sam_decoder.cu" and f'extern "C" int {symbol}(' in src


class Emulated:
    """_build.launch for the four kernels on CPU tensors: checks the
    arguments against the C signature's types and the shapes the kernel
    reads, then writes what the kernel writes, by the plain versions."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append(name)
        _, _, types = _build.KERNELS[name]
        assert len(args) == len(types)
        for a, t in zip(args, types):
            want = {_build._P: torch.Tensor, _build._I: int, _build._F: float}[t]
            assert isinstance(a, want), (name, a, t)
        if name == "sam_stream_init":
            image, dense, pe, n, C, B, keys, kpe = args
            assert (n, C) == pe.shape and image.shape == (1, C, *image.shape[2:])
            k, kp = sd.stream_init_plain(image, dense, pe, B)
            keys.copy_(k)
            kpe.copy_(kp)
        elif name == "sam_t2i_attend":
            q, k, v, B, T, n, part_acc, part_ml, out = args
            S = -(-n // sd.CHUNK)
            assert q.shape == (B, T, sd.INNER) and k.shape == v.shape == (B, n, sd.INNER)
            assert part_acc.shape == (B, S, T, sd.INNER) and part_ml.shape == (B, S, T, 8, 2)
            out.copy_(sd.cross_attend_plain(q, k, v, sd.HEADS))
        elif name == "sam_i2t_attend":
            q, k, v, B, T, n, out = args
            assert q.shape == out.shape == (B, n, sd.INNER) and k.shape == (B, T, sd.INNER)
            out.copy_(sd.cross_attend_plain(q, k, v, sd.HEADS))
        else:
            x, y, w, b, pe, B, n, eps, out, out_pe = args
            assert x.shape == y.shape == out.shape == (B, n, sd.WIDTH) and eps == 1e-5
            o, o_pe = sd.residual_ln_plain(x, y, w, b, eps, pe)
            out.copy_(o)
            out_pe.copy_(o_pe)


def test_decode_through_the_wrappers_at_the_released_widths(monkeypatch):
    """SAM's released decoder (256 wide, 8 heads, cross attention at 128)
    over an 8 x 8 grid and 3 prompts, every image-stream function through
    its kernel wrapper with the launches emulated: one stream_init, three
    token-to-image and two image-to-token attentions and two residual norms
    a decode, and the masks and IoUs of the plain decode."""
    cfg = SamConfig()
    dec = seeded(MaskDecoder(cfg), seed=4, scale=0.1)
    pe = seeded(PromptEncoder(cfg.prompt_embed_dim, GRID, 128, cfg.mask_in_chans), seed=5)
    image = randn(1, cfg.prompt_embed_dim, GRID, GRID, seed=6)
    pts = torch.rand(3, 1, 2, generator=torch.Generator().manual_seed(7)) * 128
    sparse = pe.sparse(pts, torch.ones(3, 1, dtype=torch.int64))

    def decode():
        with torch.no_grad():
            return dec(image, pe.image_pe(), sparse, pe.dense())

    want = decode()
    fake = Emulated()
    monkeypatch.setattr(_build, "launch", fake)
    for name in ("stream_init", "t2i_attend", "i2t_attend", "residual_ln"):
        monkeypatch.setattr(sd, name, getattr(sd, f"{name}_kernel"))
    got = decode()
    assert sorted(fake.calls) == sorted(["sam_stream_init"] + ["sam_t2i_attend"] * 3
                                        + ["sam_i2t_attend"] * 2 + ["sam_residual_ln"] * 2)
    assert rel(got[0], want[0]) <= RTOL and rel(got[1], want[1]) <= RTOL
