"""MASt3R/DUSt3R weights: the released torch checkpoints, the JAX
package's converted .npz, and the carry between them.

Counterpart of ``gflow_tpu/models/mast3r/convert.py``. The rule table is a
copy of that module's: released CroCo/DUSt3R key -> (flat JAX path,
transform), for both released head families (``linear`` and
``catmlp+dpt``, detected from the keys). The port's ``Mast3rModel`` is
named after the released keys, so a released state dict loads into it as
it is, once the keys the model never uses are dropped
(``_IGNORED_PREFIXES``: ``mask_token``, ``prediction_head`` and the dead
``refinenet4.resConfUnit1``). The table serves the other directions:

- ``convert_state_dict`` + ``save_npz``: released keys -> the JAX
  package's flat ``.npz``, as ``convert_weights`` writes it;
- ``state_dict_from_npz``: such an ``.npz`` -> a strict state dict for the
  port's model (the transposes inverted);
- ``load_weights``: a released ``.pth`` or a converted ``.npz`` -> that
  state dict; ``config_for_state_dict`` sizes the model from it;
- ``expected_torch_keys``, ``detect_head`` and ``dry_run``, with the JAX
  module's output.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _dense(arr):  # torch Linear (O, I) -> flax Dense kernel (I, O)
    return np.asarray(arr, np.float32).T


def _conv(arr):   # torch Conv2d (O, I, kh, kw) -> flax (kh, kw, I, O)
    return np.asarray(arr, np.float32).transpose(2, 3, 1, 0)


def _vec(arr):
    return np.asarray(arr, np.float32)


def _convT(arr):  # torch ConvTranspose2d (I, O, kh, kw) -> (kh, kw, I, O)
    return np.asarray(arr, np.float32).transpose(2, 3, 0, 1)


def _block_rules(dst_prefix: str, cross: bool):
    """torch-suffix -> (flax-suffix, transform) for one transformer block."""
    rules = {
        "norm1.weight": ("norm1/scale", _vec),
        "norm1.bias": ("norm1/bias", _vec),
        "attn.qkv.weight": ("attn/qkv/kernel", _dense),
        "attn.qkv.bias": ("attn/qkv/bias", _vec),
        "attn.proj.weight": ("attn/proj/kernel", _dense),
        "attn.proj.bias": ("attn/proj/bias", _vec),
        "norm2.weight": ("norm2/scale", _vec),
        "norm2.bias": ("norm2/bias", _vec),
        "mlp.fc1.weight": ("mlp/fc1/kernel", _dense),
        "mlp.fc1.bias": ("mlp/fc1/bias", _vec),
        "mlp.fc2.weight": ("mlp/fc2/kernel", _dense),
        "mlp.fc2.bias": ("mlp/fc2/bias", _vec),
    }
    if cross:
        rules.update({
            "norm3.weight": ("norm3/scale", _vec),
            "norm3.bias": ("norm3/bias", _vec),
            "norm_y.weight": ("norm_y/scale", _vec),
            "norm_y.bias": ("norm_y/bias", _vec),
            "cross_attn.projq.weight": ("cross_attn/projq/kernel", _dense),
            "cross_attn.projq.bias": ("cross_attn/projq/bias", _vec),
            "cross_attn.projk.weight": ("cross_attn/projk/kernel", _dense),
            "cross_attn.projk.bias": ("cross_attn/projk/bias", _vec),
            "cross_attn.projv.weight": ("cross_attn/projv/kernel", _dense),
            "cross_attn.projv.bias": ("cross_attn/projv/bias", _vec),
            "cross_attn.proj.weight": ("cross_attn/proj/kernel", _dense),
            "cross_attn.proj.bias": ("cross_attn/proj/bias", _vec),
        })
    return {k: (f"{dst_prefix}/{v}", f) for k, (v, f) in rules.items()}


def _dpt_head_rules(i: int) -> dict:
    """Rules for downstream_head{i}.{dpt,head_local_features} (catmlp+dpt).

    torch module -> flax name: act_postprocess.{j}.{k} -> dpt/act_{j}_{k}
    (k=0 is the 1x1 conv; k=1 is a convT for j<2, a strided conv for j=3),
    scratch.layerN_rn / scratch.refinenetN -> dpt/layerN_rn, dpt/refinenetN,
    head.{0,2,4} -> dpt/head_{0,2,4}."""
    src = f"downstream_head{i}"
    dst = f"downstream_head{i}"
    rules = {}

    def conv(s, d, transform=_conv, bias=True):
        rules[f"{src}.{s}.weight"] = (f"{dst}/{d}/kernel", transform)
        if bias:
            rules[f"{src}.{s}.bias"] = (f"{dst}/{d}/bias", _vec)

    conv("dpt.act_postprocess.0.0", "dpt/act_0_0")
    conv("dpt.act_postprocess.0.1", "dpt/act_0_1", _convT)
    conv("dpt.act_postprocess.1.0", "dpt/act_1_0")
    conv("dpt.act_postprocess.1.1", "dpt/act_1_1", _convT)
    conv("dpt.act_postprocess.2.0", "dpt/act_2_0")
    conv("dpt.act_postprocess.3.0", "dpt/act_3_0")
    conv("dpt.act_postprocess.3.1", "dpt/act_3_1")
    for n in range(1, 5):
        conv(f"dpt.scratch.layer{n}_rn", f"dpt/layer{n}_rn", bias=False)
        conv(f"dpt.scratch.refinenet{n}.out_conv", f"dpt/refinenet{n}/out_conv")
        for u in (1, 2):
            if n == 4 and u == 1:
                continue  # dead in torch forward; dropped via _IGNORED
            for cn in (1, 2):
                conv(f"dpt.scratch.refinenet{n}.resConfUnit{u}.conv{cn}",
                     f"dpt/refinenet{n}/resConfUnit{u}/conv{cn}")
    conv("dpt.head.0", "dpt/head_0")
    conv("dpt.head.2", "dpt/head_2")
    conv("dpt.head.4", "dpt/head_4")
    for fc in ("fc1", "fc2"):
        rules[f"{src}.head_local_features.{fc}.weight"] = (
            f"{dst}/head_local_features/{fc}/kernel", _dense)
        rules[f"{src}.head_local_features.{fc}.bias"] = (
            f"{dst}/head_local_features/{fc}/bias", _vec)
    return rules


def _build_rules(enc_depth: int, dec_depth: int,
                 head: str = "linear") -> dict:
    rules = {
        "patch_embed.proj.weight": ("patch_embed/kernel", _conv),
        "patch_embed.proj.bias": ("patch_embed/bias", _vec),
        "enc_norm.weight": ("enc_norm/scale", _vec),
        "enc_norm.bias": ("enc_norm/bias", _vec),
        "decoder_embed.weight": ("decoder_embed/kernel", _dense),
        "decoder_embed.bias": ("decoder_embed/bias", _vec),
        "dec_norm.weight": ("dec_norm/scale", _vec),
        "dec_norm.bias": ("dec_norm/bias", _vec),
    }
    if head == "catmlp+dpt":
        rules.update(_dpt_head_rules(1))
        rules.update(_dpt_head_rules(2))
    else:
        rules.update({
            "downstream_head1.proj.weight": ("downstream_head1/proj/kernel", _dense),
            "downstream_head1.proj.bias": ("downstream_head1/proj/bias", _vec),
            "downstream_head2.proj.weight": ("downstream_head2/proj/kernel", _dense),
            "downstream_head2.proj.bias": ("downstream_head2/proj/bias", _vec),
        })
    for i in range(enc_depth):
        for k, v in _block_rules(f"enc_blocks_{i}", cross=False).items():
            rules[f"enc_blocks.{i}.{k}"] = v
    for i in range(dec_depth):
        for k, v in _block_rules(f"dec_blocks_{i}", cross=True).items():
            rules[f"dec_blocks.{i}.{k}"] = v
        for k, v in _block_rules(f"dec_blocks2_{i}", cross=True).items():
            rules[f"dec_blocks2.{i}.{k}"] = v
    return rules


def expected_torch_keys(enc_depth: int = 24, dec_depth: int = 12,
                        enc_dim: int = 1024, dec_dim: int = 768,
                        patch_size: int = 16, head: str = "linear",
                        desc_dim: int = 24) -> dict:
    """torch key -> shape manifest for the released layouts (head='linear'
    for DUSt3R *_linear, 'catmlp+dpt' for the MASt3R checkpoints)."""
    p, E, D = patch_size, enc_dim, dec_dim
    out_ch = 4 * p * p
    shapes = {
        "patch_embed.proj.weight": (E, 3, p, p),
        "patch_embed.proj.bias": (E,),
        "enc_norm.weight": (E,), "enc_norm.bias": (E,),
        "decoder_embed.weight": (D, E), "decoder_embed.bias": (D,),
        "dec_norm.weight": (D,), "dec_norm.bias": (D,),
    }
    if head == "catmlp+dpt":
        ld = (96, 192, 384, 768)
        f, idim = 256, E + D
        for i in (1, 2):
            hp = f"downstream_head{i}"
            dims = (E, D, D, D)
            shapes.update({
                f"{hp}.dpt.act_postprocess.0.0.weight": (ld[0], dims[0], 1, 1),
                f"{hp}.dpt.act_postprocess.0.0.bias": (ld[0],),
                f"{hp}.dpt.act_postprocess.0.1.weight": (ld[0], ld[0], 4, 4),
                f"{hp}.dpt.act_postprocess.0.1.bias": (ld[0],),
                f"{hp}.dpt.act_postprocess.1.0.weight": (ld[1], dims[1], 1, 1),
                f"{hp}.dpt.act_postprocess.1.0.bias": (ld[1],),
                f"{hp}.dpt.act_postprocess.1.1.weight": (ld[1], ld[1], 2, 2),
                f"{hp}.dpt.act_postprocess.1.1.bias": (ld[1],),
                f"{hp}.dpt.act_postprocess.2.0.weight": (ld[2], dims[2], 1, 1),
                f"{hp}.dpt.act_postprocess.2.0.bias": (ld[2],),
                f"{hp}.dpt.act_postprocess.3.0.weight": (ld[3], dims[3], 1, 1),
                f"{hp}.dpt.act_postprocess.3.0.bias": (ld[3],),
                f"{hp}.dpt.act_postprocess.3.1.weight": (ld[3], ld[3], 3, 3),
                f"{hp}.dpt.act_postprocess.3.1.bias": (ld[3],),
                f"{hp}.dpt.head.0.weight": (f // 2, f, 3, 3),
                f"{hp}.dpt.head.0.bias": (f // 2,),
                f"{hp}.dpt.head.2.weight": (f // 2, f // 2, 3, 3),
                f"{hp}.dpt.head.2.bias": (f // 2,),
                f"{hp}.dpt.head.4.weight": (4, f // 2, 1, 1),
                f"{hp}.dpt.head.4.bias": (4,),
                f"{hp}.head_local_features.fc1.weight": (4 * idim, idim),
                f"{hp}.head_local_features.fc1.bias": (4 * idim,),
                f"{hp}.head_local_features.fc2.weight":
                    ((desc_dim + 1) * p * p, 4 * idim),
                f"{hp}.head_local_features.fc2.bias":
                    ((desc_dim + 1) * p * p,),
            })
            for n in range(1, 5):
                shapes[f"{hp}.dpt.scratch.layer{n}_rn.weight"] = (
                    f, ld[n - 1], 3, 3)
                rf = f"{hp}.dpt.scratch.refinenet{n}"
                shapes[f"{rf}.out_conv.weight"] = (f, f, 1, 1)
                shapes[f"{rf}.out_conv.bias"] = (f,)
                for u in (1, 2):  # resConfUnit1 exists even where unused
                    for cn in (1, 2):
                        shapes[f"{rf}.resConfUnit{u}.conv{cn}.weight"] = (
                            f, f, 3, 3)
                        shapes[f"{rf}.resConfUnit{u}.conv{cn}.bias"] = (f,)
    else:
        shapes.update({
            "downstream_head1.proj.weight": (out_ch, D),
            "downstream_head1.proj.bias": (out_ch,),
            "downstream_head2.proj.weight": (out_ch, D),
            "downstream_head2.proj.bias": (out_ch,),
        })

    def block(prefix, d, cross):
        shapes.update({
            f"{prefix}.norm1.weight": (d,), f"{prefix}.norm1.bias": (d,),
            f"{prefix}.attn.qkv.weight": (3 * d, d),
            f"{prefix}.attn.qkv.bias": (3 * d,),
            f"{prefix}.attn.proj.weight": (d, d),
            f"{prefix}.attn.proj.bias": (d,),
            f"{prefix}.norm2.weight": (d,), f"{prefix}.norm2.bias": (d,),
            f"{prefix}.mlp.fc1.weight": (4 * d, d),
            f"{prefix}.mlp.fc1.bias": (4 * d,),
            f"{prefix}.mlp.fc2.weight": (d, 4 * d),
            f"{prefix}.mlp.fc2.bias": (d,),
        })
        if cross:
            shapes.update({
                f"{prefix}.norm3.weight": (d,), f"{prefix}.norm3.bias": (d,),
                f"{prefix}.norm_y.weight": (d,), f"{prefix}.norm_y.bias": (d,),
                f"{prefix}.cross_attn.projq.weight": (d, d),
                f"{prefix}.cross_attn.projq.bias": (d,),
                f"{prefix}.cross_attn.projk.weight": (d, d),
                f"{prefix}.cross_attn.projk.bias": (d,),
                f"{prefix}.cross_attn.projv.weight": (d, d),
                f"{prefix}.cross_attn.projv.bias": (d,),
                f"{prefix}.cross_attn.proj.weight": (d, d),
                f"{prefix}.cross_attn.proj.bias": (d,),
            })

    for i in range(enc_depth):
        block(f"enc_blocks.{i}", E, cross=False)
    for i in range(dec_depth):
        block(f"dec_blocks.{i}", D, cross=True)
        block(f"dec_blocks2.{i}", D, cross=True)
    return shapes


# torch key prefixes that released checkpoints carry but the flax tree
# deliberately does not: masking tokens, alternate prediction heads, and the
# top fusion block's resConfUnit1 (constructed but never run by the torch
# forward — dead weights in every released DPT checkpoint)
_IGNORED_PREFIXES = (
    "mask_token", "prediction_head",
    "downstream_head1.dpt.scratch.refinenet4.resConfUnit1",
    "downstream_head2.dpt.scratch.refinenet4.resConfUnit1",
)


def detect_head(sd: dict) -> str:
    """'catmlp+dpt' if the state dict carries DPT head weights, else
    'linear'."""
    return ("catmlp+dpt"
            if any(k.startswith("downstream_head1.dpt.") for k in sd)
            else "linear")


def convert_state_dict(sd: dict, enc_depth: int = 24, dec_depth: int = 12,
                       strict: bool = True, head: str | None = None) -> dict:
    """torch state dict -> flat flax {'path/leaf': array}. Raises on any
    unmapped torch key or missing flax parameter (strict). head=None
    auto-detects the released head family (detect_head)."""
    head = head or detect_head(sd)
    rules = _build_rules(enc_depth, dec_depth, head)
    out = {}
    unmatched = []
    for k, v in sd.items():
        if k.endswith(".num_batches_tracked"):
            continue
        if any(k.startswith(p) for p in _IGNORED_PREFIXES):
            continue
        rule = rules.pop(k, None)
        if rule is None:
            unmatched.append(k)
            continue
        dst, f = rule
        out[dst] = f(v)
    if strict and (unmatched or rules):
        raise KeyError(
            f"MASt3R convert ({head}): {len(unmatched)} unmapped checkpoint "
            f"keys (e.g. {unmatched[:5]}) and {len(rules)} expected keys "
            f"absent (e.g. {list(rules)[:5]}). Adjust _build_rules or pass "
            "strict=False to inspect."
        )
    return out


def save_npz(tree_flat: dict, path: str):
    np.savez_compressed(path, **tree_flat)


def dry_run(manifest: dict | None = None, enc_depth: int = 24,
            dec_depth: int = 12, head: str | None = None) -> dict:
    """Validate the converter WITHOUT weights (weights-gated environments).

    manifest: {torch_key: shape_list} as produced from a released checkpoint
    by `{k: list(v.shape) for k, v in torch.load(p)["model"].items()}`.
    Runs the full strict mapping over zero-byte broadcast arrays of those
    shapes — every released key must map, every expected flax param must be
    produced — and returns a summary. With manifest=None, returns the
    expected checkpoint key inventory so a download can be diffed before
    conversion."""
    if manifest is None:
        rules = _build_rules(enc_depth, dec_depth, head or "catmlp+dpt")
        return {"model": "mast3r", "head": head or "catmlp+dpt",
                "expected_keys": sorted(rules),
                "ignored_prefixes": list(_IGNORED_PREFIXES)}
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, tuple(v)) for k, v in manifest.items()}
    out = convert_state_dict(sd, enc_depth, dec_depth, head=head)
    return {"model": "mast3r", "head": head or detect_head(sd), "ok": True,
            "checkpoint_keys": len(manifest), "flax_params": len(out),
            "total_parameters": int(sum(v.size for v in out.values()))}


def convert_file(checkpoint_path: str, out_path: str,
                 enc_depth: int = 24, dec_depth: int = 12) -> str:
    """Convert a released .pth to the .npz the JAX package's prep_depth
    loads (this package's loads both)."""
    sd = {k: v.numpy() for k, v in _read_pth(checkpoint_path).items()}
    save_npz(convert_state_dict(sd, enc_depth, dec_depth), out_path)
    return out_path


def _read_pth(path) -> dict:
    """A released checkpoint's state dict (under "model" where it is
    wrapped), as CPU tensors."""
    d = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in d and isinstance(d["model"], dict):
        d = d["model"]
    return {k: torch.as_tensor(v) for k, v in d.items()}


_INVERSE = {_dense: lambda a: a.T, _conv: lambda a: a.transpose(3, 2, 0, 1),
            _convT: lambda a: a.transpose(2, 3, 0, 1), _vec: lambda a: a}


def _count(keys, pattern) -> int:
    found = [int(m.group(1)) for k in keys if (m := re.match(pattern, k))]
    return 1 + max(found) if found else 0


def _desc_rules() -> dict:
    """The linear head's optional descriptor extension (``desc_proj``),
    which DUSt3R checkpoints do not carry."""
    return {f"downstream_head{i}.desc_proj.{leaf}": (f"downstream_head{i}/desc_proj/{dst}", f)
            for i in (1, 2) for leaf, dst, f in (("weight", "kernel", _dense),
                                                 ("bias", "bias", _vec))}


def state_dict_from_npz(flat: dict) -> dict:
    """The JAX package's flat converted params ({'a/b/kernel': array}) ->
    the released-key state dict the port's Mast3rModel loads strictly.
    Depths and head family come from the paths. Raises KeyError on any
    path the rule table does not produce or leaves unset."""
    head = "catmlp+dpt" if any(k.startswith("downstream_head1/dpt/") for k in flat) else "linear"
    rules = _build_rules(_count(flat, r"enc_blocks_(\d+)/"), _count(flat, r"dec_blocks_(\d+)/"),
                         head)
    if "downstream_head1/desc_proj/kernel" in flat:
        rules.update(_desc_rules())
    by_dst = {dst: (k, f) for k, (dst, f) in rules.items()}
    unmatched = sorted(set(flat) - set(by_dst))
    absent = sorted(set(by_dst) - set(flat))
    if unmatched or absent:
        raise KeyError(f"MASt3R npz ({head}): {len(unmatched)} unknown paths "
                       f"(e.g. {unmatched[:5]}) and {len(absent)} absent (e.g. {absent[:5]})")
    return {k: torch.from_numpy(np.ascontiguousarray(_INVERSE[f](np.asarray(flat[dst], np.float32))))
            for dst, (k, f) in by_dst.items()}


def load_weights(path) -> dict:
    """A released MASt3R/DUSt3R ``.pth`` or the JAX package's converted
    ``.npz`` -> a state dict of CPU tensors under the released keys, with
    exactly ``_IGNORED_PREFIXES`` (and ``num_batches_tracked``) dropped."""
    if str(path).endswith(".npz"):
        with np.load(path) as d:
            return state_dict_from_npz({k: d[k] for k in d.files})
    return {k: v for k, v in _read_pth(path).items()
            if not k.endswith(".num_batches_tracked")
            and not any(k.startswith(p) for p in _IGNORED_PREFIXES)}


def config_for_state_dict(sd: dict):
    """The Mast3rConfig a released-layout state dict fits: head family
    (``detect_head``), descriptor head, widths, depths and patch size from
    its keys and shapes. Heads are width / 64, as in the released ViT-L
    encoder (16) and ViT-B decoder (12)."""
    from .vit import Mast3rConfig

    enc_dim, _, p, _ = sd["patch_embed.proj.weight"].shape
    dec_dim = sd["decoder_embed.weight"].shape[0]
    head = detect_head(sd)
    if head == "catmlp+dpt":
        desc_dim = sd["downstream_head1.head_local_features.fc2.weight"].shape[0] // p**2 - 1
    elif "downstream_head1.desc_proj.weight" in sd:
        desc_dim = sd["downstream_head1.desc_proj.weight"].shape[0] // p**2 - 1
    else:
        desc_dim = Mast3rConfig.desc_dim
    return Mast3rConfig(
        patch_size=int(p), enc_dim=int(enc_dim), enc_depth=_count(sd, r"enc_blocks\.(\d+)\."),
        enc_heads=max(1, int(enc_dim) // 64), dec_dim=int(dec_dim),
        dec_depth=_count(sd, r"dec_blocks\.(\d+)\."), dec_heads=max(1, int(dec_dim) // 64),
        desc_dim=int(desc_dim), head=head,
        with_desc=head == "linear" and "downstream_head1.desc_proj.weight" in sd)
