"""SAM 2 weights: the released checkpoints (``sam2.1_hiera_large.pt`` and
its siblings, a state dict under ``"model"``) load into ``Sam2Model`` as
they are.

- ``expected_torch_keys``: the released key -> shape manifest, written out
  from the published layout (``sam2/modeling/``, the yaml configs), for
  seeded weights (``models.random_weights``) and to check the model
  against;
- ``load_weights``: a released ``.pt`` -> a state dict of CPU tensors;
- ``config_for_state_dict``: the ``Sam2Config`` a state dict fits.
"""
from __future__ import annotations

import re

import torch

from .hiera import block_plan
from .model import Sam2Config


def expected_torch_keys(c: Sam2Config = Sam2Config()) -> dict:
    """{released key: shape} of the model `c` describes."""
    C, M, E = c.d_model, c.mem_dim, c.embed_dim
    shapes = {}

    def lin(key, o, i):
        shapes[key + ".weight"], shapes[key + ".bias"] = (o, i), (o,)

    def norm(key, n):
        shapes[key + ".weight"], shapes[key + ".bias"] = (n,), (n,)

    def conv(key, o, i, k):
        shapes[key + ".weight"], shapes[key + ".bias"] = (o, i, k, k), (o,)

    t = "image_encoder.trunk"
    conv(f"{t}.patch_embed.proj", E, 3, 7)
    shapes[f"{t}.pos_embed"] = (1, E, *c.window_pos_embed_bkg_spatial_size)
    shapes[f"{t}.pos_embed_window"] = (1, E, c.window_spec[0], c.window_spec[0])
    plan, ends = block_plan(c)
    for i, (d, do, _, _, _) in enumerate(plan):
        b = f"{t}.blocks.{i}"
        norm(b + ".norm1", d)
        lin(b + ".attn.qkv", 3 * do, d)
        lin(b + ".attn.proj", do, do)
        norm(b + ".norm2", do)
        lin(b + ".mlp.layers.0", int(do * c.mlp_ratio), do)
        lin(b + ".mlp.layers.1", do, int(do * c.mlp_ratio))
        if d != do:
            lin(b + ".proj", do, d)
    for j, ch in enumerate([plan[e][1] for e in ends][::-1]):
        conv(f"image_encoder.neck.convs.{j}.conv", C, ch, 1)

    conv("mask_downsample", 1, 1, 4)
    for i in range(c.memattn_layers):
        l = f"memory_attention.layers.{i}"
        for a, kv in (("self_attn", C), ("cross_attn_image", M)):
            lin(f"{l}.{a}.q_proj", C, C)
            lin(f"{l}.{a}.k_proj", C, kv)
            lin(f"{l}.{a}.v_proj", C, kv)
            lin(f"{l}.{a}.out_proj", C, C)
        lin(f"{l}.linear1", c.memattn_ffn, C)
        lin(f"{l}.linear2", C, c.memattn_ffn)
        for n in (1, 2, 3):
            norm(f"{l}.norm{n}", C)
    norm("memory_attention.norm", C)

    e = "memory_encoder"
    cin, at = 1, 0
    layers = c.mask_ds_total_stride.bit_length() - 1
    step = c.mask_ds_stride.bit_length() - 1
    for _ in range(layers // step):
        cout = cin * c.mask_ds_stride ** 2
        conv(f"{e}.mask_downsampler.encoder.{at}", cout, cin, c.mask_ds_kernel)
        norm(f"{e}.mask_downsampler.encoder.{at + 1}", cout)
        cin, at = cout, at + 3
    conv(f"{e}.mask_downsampler.encoder.{at}", C, cin, 1)
    conv(f"{e}.pix_feat_proj", C, C, 1)
    for i in range(c.fuser_layers):
        f = f"{e}.fuser.layers.{i}"
        shapes[f"{f}.gamma"] = (C,)
        shapes[f"{f}.dwconv.weight"], shapes[f"{f}.dwconv.bias"] = (C, 1, c.fuser_kernel,
                                                                    c.fuser_kernel), (C,)
        norm(f"{f}.norm", C)
        lin(f"{f}.pwconv1", 4 * C, C)
        lin(f"{f}.pwconv2", C, 4 * C)
    conv(f"{e}.out_proj", M, C, 1)

    shapes.update({"maskmem_tpos_enc": (c.num_maskmem, 1, 1, M), "no_mem_embed": (1, 1, C),
                   "no_mem_pos_enc": (1, 1, C), "no_obj_ptr": (1, C),
                   "no_obj_embed_spatial": (1, M)})
    for j in range(3):
        lin(f"obj_ptr_proj.layers.{j}", C, C)
    lin("obj_ptr_tpos_proj", M, C)

    pe = "sam_prompt_encoder"
    m4, m = c.mask_in_chans // 4, c.mask_in_chans
    shapes[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = (2, C // 2)
    for i in range(4):
        shapes[f"{pe}.point_embeddings.{i}.weight"] = (1, C)
    shapes[f"{pe}.not_a_point_embed.weight"] = (1, C)
    shapes[f"{pe}.mask_downscaling.0.weight"], shapes[f"{pe}.mask_downscaling.0.bias"] = \
        (m4, 1, 2, 2), (m4,)
    norm(f"{pe}.mask_downscaling.1", m4)
    shapes[f"{pe}.mask_downscaling.3.weight"], shapes[f"{pe}.mask_downscaling.3.bias"] = \
        (m, m4, 2, 2), (m,)
    norm(f"{pe}.mask_downscaling.4", m)
    conv(f"{pe}.mask_downscaling.6", C, m, 1)
    shapes[f"{pe}.no_mask_embed.weight"] = (1, C)

    md = "sam_mask_decoder"
    tr, inner = f"{md}.transformer", C // c.attention_downsample_rate

    def attn(prefix, width):
        for p in ("q_proj", "k_proj", "v_proj"):
            lin(f"{prefix}.{p}", width, C)
        lin(f"{prefix}.out_proj", C, width)

    for i in range(c.decoder_depth):
        l = f"{tr}.layers.{i}"
        attn(f"{l}.self_attn", C)
        attn(f"{l}.cross_attn_token_to_image", inner)
        attn(f"{l}.cross_attn_image_to_token", inner)
        for n in (1, 2, 3, 4):
            norm(f"{l}.norm{n}", C)
        lin(f"{l}.mlp.lin1", c.decoder_mlp_dim, C)
        lin(f"{l}.mlp.lin2", C, c.decoder_mlp_dim)
    attn(f"{tr}.final_attn_token_to_image", inner)
    norm(f"{tr}.norm_final_attn", C)
    T = c.num_multimask_outputs + 1
    shapes.update({f"{md}.iou_token.weight": (1, C), f"{md}.mask_tokens.weight": (T, C),
                   f"{md}.obj_score_token.weight": (1, C)})
    shapes[f"{md}.output_upscaling.0.weight"] = (C, C // 4, 2, 2)
    shapes[f"{md}.output_upscaling.0.bias"] = (C // 4,)
    norm(f"{md}.output_upscaling.1", C // 4)
    shapes[f"{md}.output_upscaling.3.weight"] = (C // 4, C // 8, 2, 2)
    shapes[f"{md}.output_upscaling.3.bias"] = (C // 8,)
    conv(f"{md}.conv_s0", C // 8, C, 1)
    conv(f"{md}.conv_s1", C // 4, C, 1)
    for i in range(T):
        for j, (a, b) in enumerate(((C, C), (C, C), (C, C // 8))):
            lin(f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", b, a)
    h = c.iou_head_hidden_dim
    dims = (C,) + (h,) * (c.iou_head_depth - 1) + (T,)
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lin(f"{md}.iou_prediction_head.layers.{j}", b, a)
    for j, (a, b) in enumerate(((C, C), (C, C), (C, 1))):
        lin(f"{md}.pred_obj_score_head.layers.{j}", b, a)
    return shapes


def load_weights(path) -> dict:
    """A released SAM 2 ``.pt`` (a state dict, or one under ``"model"``)
    -> {key: float32 CPU tensor}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    return {k: v.float() for k, v in sd.items()}


def _count(keys, pattern) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in keys if (m := rx.match(k))})


def config_for_state_dict(sd: dict) -> Sam2Config:
    """The Sam2Config a released-layout state dict fits: the trunk's
    width, stages (a block with ``proj`` starts a stage), the windows and
    heads are not all in the keys, so widths and depths come from the keys
    and the rest from the published configuration whose width matches
    (Hiera-T/S 96, B+ 112, L 144)."""
    t = "image_encoder.trunk"
    E = sd[f"{t}.patch_embed.proj.weight"].shape[0]
    depth = _count(sd, rf"{re.escape(t)}\.blocks\.(\d+)\.")
    starts = [i for i in range(depth) if f"{t}.blocks.{i}.proj.weight" in sd]
    bounds = [0] + starts + [depth]
    stages = tuple(b - a for a, b in zip(bounds[:-1], bounds[1:]))
    published = {144: dict(num_heads=2, global_att_blocks=(23, 33, 43),
                           window_spec=(8, 4, 16, 8), window_pos_embed_bkg_spatial_size=(7, 7)),
                 112: dict(num_heads=2, global_att_blocks=(12, 16, 20),
                           window_spec=(8, 4, 14, 7), window_pos_embed_bkg_spatial_size=(14, 14)),
                 96: dict(num_heads=1, global_att_blocks=(5, 7, 9) if depth == 12
                          else (7, 10, 13), window_spec=(8, 4, 14, 7),
                          window_pos_embed_bkg_spatial_size=(7, 7))}
    if E not in published:
        raise ValueError(f"no published SAM 2 trunk is {E} wide")
    C = sd["memory_attention.norm.weight"].shape[0]
    return Sam2Config(
        embed_dim=E, stages=stages, d_model=C, **published[E],
        memattn_layers=_count(sd, r"memory_attention\.layers\.(\d+)\."),
        memattn_ffn=sd["memory_attention.layers.0.linear1.weight"].shape[0],
        mem_dim=sd["maskmem_tpos_enc"].shape[-1], num_maskmem=sd["maskmem_tpos_enc"].shape[0],
        prompt_embed_dim=C,
        decoder_mlp_dim=sd["sam_mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0])
