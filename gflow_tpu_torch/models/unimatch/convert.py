"""UniMatch (GMFlow) weights: the released torch checkpoint, the JAX
package's converted .npz, and the carry between them.

Counterpart of ``gflow_tpu/models/unimatch/convert.py``. The rule table is
a copy of that module's: released key -> (flat JAX path, transform), for
gmflow-scale2-regrefine6 (see gmflow.py). The port's ``GMFlow`` is named
after the released keys, so a released state dict loads into it as it is;
the table serves the other directions:

- ``convert_state_dict`` + ``save_npz``: released keys -> the JAX
  package's flat ``.npz`` ('a/b/kernel' arrays), as ``convert_weights``
  writes it;
- ``state_dict_from_npz``: such an ``.npz`` -> a strict state dict for the
  port's ``GMFlow`` (the transposes inverted);
- ``load_weights``: a released ``.pth`` or a converted ``.npz`` -> that
  state dict; ``config_for_state_dict`` sizes the model from it;
- ``expected_torch_keys`` and ``dry_run``: the key inventory and the
  manifest check, with the JAX module's output.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _dense(arr):  # torch Linear (O, I) -> flax kernel (I, O)
    return np.asarray(arr, np.float32).T


def _conv(arr):   # torch Conv2d (O, I, kh, kw) -> flax (kh, kw, I, O)
    return np.asarray(arr, np.float32).transpose(2, 3, 1, 0)


def _vec(arr):
    return np.asarray(arr, np.float32)


def _res_block(dst):
    return {
        "conv1.weight": (f"{dst}/conv1/kernel", _conv),
        "conv1.bias": (f"{dst}/conv1/bias", _vec),
        "conv2.weight": (f"{dst}/conv2/kernel", _conv),
        "conv2.bias": (f"{dst}/conv2/bias", _vec),
        "downsample.0.weight": (f"{dst}/downsample/kernel", _conv),
        "downsample.0.bias": (f"{dst}/downsample/bias", _vec),
    }


def _tf_layer(dst, ffn: bool):
    """Upstream builds self_attn with no_ffn=True — only cross_attn_ffn
    carries mlp/norm2 (the released checkpoint has no self_attn.mlp keys)."""
    rules = {
        "q_proj.weight": (f"{dst}/q_proj/kernel", _dense),
        "k_proj.weight": (f"{dst}/k_proj/kernel", _dense),
        "v_proj.weight": (f"{dst}/v_proj/kernel", _dense),
        "merge.weight": (f"{dst}/merge/kernel", _dense),
        "norm1.weight": (f"{dst}/norm1/scale", _vec),
        "norm1.bias": (f"{dst}/norm1/bias", _vec),
    }
    if ffn:
        rules.update({
            "norm2.weight": (f"{dst}/norm2/scale", _vec),
            "norm2.bias": (f"{dst}/norm2/bias", _vec),
            "mlp.0.weight": (f"{dst}/mlp_0/kernel", _dense),
            "mlp.2.weight": (f"{dst}/mlp_2/kernel", _dense),
        })
    return rules


def _build_rules(num_layers: int = 6) -> dict:
    rules = {
        "backbone.conv1.weight": ("backbone/conv1/kernel", _conv),
        "backbone.conv1.bias": ("backbone/conv1/bias", _vec),
        "backbone.conv2.weight": ("backbone/conv2/kernel", _conv),
        "backbone.conv2.bias": ("backbone/conv2/bias", _vec),
        "backbone.trident_conv.weight": ("backbone/trident_conv/kernel", _conv),
        "backbone.trident_conv.bias": ("backbone/trident_conv/bias", _vec),
        "feature_flow_attn.q_proj.weight": ("feature_flow_attn/q_proj/kernel", _dense),
        "feature_flow_attn.q_proj.bias": ("feature_flow_attn/q_proj/bias", _vec),
        "feature_flow_attn.k_proj.weight": ("feature_flow_attn/k_proj/kernel", _dense),
        "feature_flow_attn.k_proj.bias": ("feature_flow_attn/k_proj/bias", _vec),
        "refine_proj.weight": ("refine_proj/kernel", _conv),
        "refine_proj.bias": ("refine_proj/bias", _vec),
    }
    for li, blocks in ((1, (64, 64)), (2, (96, 96)), (3, (128, 128))):
        for b in (0, 1):
            for k, v in _res_block(f"backbone/layer{li}_{b}").items():
                # only the first block of layers 2/3 (stride/width change)
                # has a downsample conv
                if k.startswith("downsample") and not (b == 0 and li > 1):
                    continue
                rules[f"backbone.layer{li}.{b}.{k}"] = v
    for i in range(num_layers):
        for sub in ("self_attn", "cross_attn_ffn"):
            layer_rules = _tf_layer(f"transformer/layers_{i}/{sub}",
                                    ffn=(sub == "cross_attn_ffn"))
            for k, v in layer_rules.items():
                rules[f"transformer.layers.{i}.{sub}.{k}"] = v
    # RAFT BasicUpdateBlock
    enc = "refine/encoder"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        rules[f"refine.encoder.{name}.weight"] = (f"{enc}/{name}/kernel", _conv)
        rules[f"refine.encoder.{name}.bias"] = (f"{enc}/{name}/bias", _vec)
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        rules[f"refine.gru.{name}.weight"] = (f"refine/gru/{name}/kernel", _conv)
        rules[f"refine.gru.{name}.bias"] = (f"refine/gru/{name}/bias", _vec)
    for name in ("conv1", "conv2"):
        rules[f"refine.flow_head.{name}.weight"] = (
            f"refine/flow_head/{name}/kernel", _conv)
        rules[f"refine.flow_head.{name}.bias"] = (
            f"refine/flow_head/{name}/bias", _vec)
    rules["refine.mask.0.weight"] = ("refine/mask_0/kernel", _conv)
    rules["refine.mask.0.bias"] = ("refine/mask_0/bias", _vec)
    rules["refine.mask.2.weight"] = ("refine/mask_2/kernel", _conv)
    rules["refine.mask.2.bias"] = ("refine/mask_2/bias", _vec)
    return rules


def expected_torch_keys(num_layers: int = 6, d: int = 128,
                        upsample_factor: int = 4) -> dict:
    """torch key -> shape manifest for gmflow-scale2-regrefine6."""
    shapes = {
        "backbone.conv1.weight": (64, 3, 7, 7),
        "backbone.conv1.bias": (64,),
        "backbone.conv2.weight": (d, 128, 1, 1),
        "backbone.conv2.bias": (d,),
        "backbone.trident_conv.weight": (d, d, 3, 3),
        "backbone.trident_conv.bias": (d,),
        "feature_flow_attn.q_proj.weight": (d, d),
        "feature_flow_attn.q_proj.bias": (d,),
        "feature_flow_attn.k_proj.weight": (d, d),
        "feature_flow_attn.k_proj.bias": (d,),
        "refine_proj.weight": (256, d, 1, 1),
        "refine_proj.bias": (256,),
    }
    chans = {1: (64, 64), 2: (64, 96), 3: (96, 128)}
    for li, (cin, cout) in chans.items():
        for b in (0, 1):
            ci = cin if b == 0 else cout
            shapes[f"backbone.layer{li}.{b}.conv1.weight"] = (cout, ci, 3, 3)
            shapes[f"backbone.layer{li}.{b}.conv1.bias"] = (cout,)
            shapes[f"backbone.layer{li}.{b}.conv2.weight"] = (cout, cout, 3, 3)
            shapes[f"backbone.layer{li}.{b}.conv2.bias"] = (cout,)
            if b == 0 and li > 1:
                shapes[f"backbone.layer{li}.{b}.downsample.0.weight"] = (
                    cout, cin, 1, 1)
                shapes[f"backbone.layer{li}.{b}.downsample.0.bias"] = (cout,)
    for i in range(num_layers):
        for sub in ("self_attn", "cross_attn_ffn"):
            p = f"transformer.layers.{i}.{sub}"
            shapes.update({
                f"{p}.q_proj.weight": (d, d),
                f"{p}.k_proj.weight": (d, d),
                f"{p}.v_proj.weight": (d, d),
                f"{p}.merge.weight": (d, d),
                f"{p}.norm1.weight": (d,), f"{p}.norm1.bias": (d,),
            })
            if sub == "cross_attn_ffn":  # self_attn is no_ffn upstream
                shapes.update({
                    f"{p}.norm2.weight": (d,), f"{p}.norm2.bias": (d,),
                    f"{p}.mlp.0.weight": (d * 2 * 4, d * 2),
                    f"{p}.mlp.2.weight": (d, d * 2 * 4),
                })
    shapes.update({
        "refine.encoder.convc1.weight": (256, 81, 1, 1),
        "refine.encoder.convc1.bias": (256,),
        "refine.encoder.convc2.weight": (192, 256, 3, 3),
        "refine.encoder.convc2.bias": (192,),
        "refine.encoder.convf1.weight": (128, 2, 7, 7),
        "refine.encoder.convf1.bias": (128,),
        "refine.encoder.convf2.weight": (64, 128, 3, 3),
        "refine.encoder.convf2.bias": (64,),
        "refine.encoder.conv.weight": (126, 256, 3, 3),
        "refine.encoder.conv.bias": (126,),
    })
    for name in ("convz1", "convr1", "convq1"):
        shapes[f"refine.gru.{name}.weight"] = (128, 384, 1, 5)
        shapes[f"refine.gru.{name}.bias"] = (128,)
    for name in ("convz2", "convr2", "convq2"):
        shapes[f"refine.gru.{name}.weight"] = (128, 384, 5, 1)
        shapes[f"refine.gru.{name}.bias"] = (128,)
    shapes.update({
        "refine.flow_head.conv1.weight": (256, 128, 3, 3),
        "refine.flow_head.conv1.bias": (256,),
        "refine.flow_head.conv2.weight": (2, 256, 3, 3),
        "refine.flow_head.conv2.bias": (2,),
        "refine.mask.0.weight": (256, 128, 3, 3),
        "refine.mask.0.bias": (256,),
        "refine.mask.2.weight": (upsample_factor**2 * 9, 256, 1, 1),
        "refine.mask.2.bias": (upsample_factor**2 * 9,),
    })
    return shapes


# checkpoint-only extras (alternate tasks/heads) that the flow tree
# deliberately does not carry
_IGNORED_PREFIXES = ("upsampler.",)  # non-refine upsampler (bilinear_up path)


def convert_state_dict(sd: dict, num_layers: int = 6,
                       strict: bool = True) -> dict:
    """torch state dict -> flat flax {'path/leaf': array}. Raises on any
    unmapped torch key or missing flax parameter (strict)."""
    rules = _build_rules(num_layers)
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
            f"UniMatch convert: {len(unmatched)} unmapped checkpoint keys "
            f"(e.g. {unmatched[:5]}) and {len(rules)} expected keys absent "
            f"(e.g. {list(rules)[:5]}). Adjust _build_rules or pass "
            "strict=False to inspect."
        )
    return out


def save_npz(tree_flat: dict, path: str):
    np.savez_compressed(path, **tree_flat)


def dry_run(manifest: dict | None = None, num_layers: int = 6) -> dict:
    """Validate the converter WITHOUT weights — see mast3r.convert.dry_run.
    manifest: {torch_key: shape_list}; None returns the expected released
    gmflow-scale2-regrefine6 checkpoint key inventory."""
    if manifest is None:
        rules = _build_rules(num_layers)
        return {"model": "unimatch", "expected_keys": sorted(rules),
                "ignored_prefixes": list(_IGNORED_PREFIXES)}
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, tuple(v)) for k, v in manifest.items()}
    out = convert_state_dict(sd, num_layers)
    return {"model": "unimatch", "ok": True,
            "checkpoint_keys": len(manifest), "flax_params": len(out),
            "total_parameters": int(sum(v.size for v in out.values()))}


def convert_file(checkpoint_path: str, out_path: str, num_layers: int = 6) -> str:
    """Convert a released UniMatch .pth to the .npz the JAX package's
    prep_flow loads (this package's loads both)."""
    sd = {k: v.numpy() for k, v in _read_pth(checkpoint_path).items()}
    save_npz(convert_state_dict(sd, num_layers), out_path)
    return out_path


def _read_pth(path) -> dict:
    """A released checkpoint's state dict (under "model" where it is
    wrapped), as CPU tensors."""
    d = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in d and isinstance(d["model"], dict):
        d = d["model"]
    return {k: torch.as_tensor(v) for k, v in d.items()}


_INVERSE = {_dense: lambda a: a.T, _conv: lambda a: a.transpose(3, 2, 0, 1),
            _vec: lambda a: a}


def _num_layers(keys, pattern) -> int:
    return 1 + max(int(m.group(1)) for k in keys if (m := re.match(pattern, k)))


def state_dict_from_npz(flat: dict) -> dict:
    """The JAX package's flat converted params ({'a/b/kernel': array}) ->
    the released-key state dict the port's GMFlow loads strictly. Raises
    KeyError on any path the rule table does not produce or leaves unset."""
    rules = _build_rules(_num_layers(flat, r"transformer/layers_(\d+)/"))
    by_dst = {dst: (k, f) for k, (dst, f) in rules.items()}
    unmatched = sorted(set(flat) - set(by_dst))
    absent = sorted(set(by_dst) - set(flat))
    if unmatched or absent:
        raise KeyError(f"UniMatch npz: {len(unmatched)} unknown paths (e.g. {unmatched[:5]}) "
                       f"and {len(absent)} absent (e.g. {absent[:5]})")
    return {k: torch.from_numpy(np.ascontiguousarray(_INVERSE[f](np.asarray(flat[dst], np.float32))))
            for dst, (k, f) in by_dst.items()}


def load_weights(path) -> dict:
    """A released UniMatch ``.pth`` or the JAX package's converted ``.npz``
    -> a state dict of CPU tensors under the released keys, without the
    keys the flow model does not carry (``_IGNORED_PREFIXES`` and
    ``num_batches_tracked``)."""
    if str(path).endswith(".npz"):
        with np.load(path) as d:
            return state_dict_from_npz({k: d[k] for k in d.files})
    return {k: v for k, v in _read_pth(path).items()
            if not k.endswith(".num_batches_tracked")
            and not any(k.startswith(p) for p in _IGNORED_PREFIXES)}


def config_for_state_dict(sd: dict, **overrides):
    """The GMFlowConfig a released-layout state dict fits: feature
    channels, transformer depth and upsampling factor from its keys and
    shapes; the rest as gmflow-scale2-regrefine6 (or `overrides`)."""
    from .gmflow import GMFlowConfig

    kw = dict(feature_channels=int(sd["backbone.conv2.weight"].shape[0]),
              num_transformer_layers=_num_layers(sd, r"transformer\.layers\.(\d+)\."),
              upsample_factor=int(round((sd["refine.mask.2.weight"].shape[0] / 9) ** 0.5)))
    kw.update(overrides)
    return GMFlowConfig(**kw)
