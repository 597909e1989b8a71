"""The released key layout of a SAM 2 checkpoint (``sam2.1_hiera_large.pt``'s
``"model"``), {key: shape}, from the published modules: what the
reference's forward reads, and what the benchmark's operation counts run
on (on the meta device)."""
from __future__ import annotations

import math

from .model import stage_layout


def state_shapes(cfg: dict) -> dict:
    C, M = cfg["d_model"], cfg["mem_dim"]
    out = {}

    def p(key, *shape):
        out[key] = tuple(shape)

    def lin(key, o, i):
        p(key + ".weight", o, i)
        p(key + ".bias", o)

    def norm(key, n):
        p(key + ".weight", n)
        p(key + ".bias", n)

    def conv(key, o, i, k, groups=1):
        p(key + ".weight", o, i // groups, k, k)
        p(key + ".bias", o)

    t = "image_encoder.trunk"
    E = cfg["embed_dim"]
    conv(t + ".patch_embed.proj", E, 3, 7)
    p(t + ".pos_embed", 1, E, *cfg["window_pos_embed_bkg_spatial_size"])
    p(t + ".pos_embed_window", 1, E, cfg["window_spec"][0], cfg["window_spec"][0])
    layout, ends = stage_layout(cfg)
    for i, (d, do, _, _, _) in enumerate(layout):
        b = f"{t}.blocks.{i}."
        hidden = int(do * cfg["mlp_ratio"])
        norm(b + "norm1", d)
        lin(b + "attn.qkv", 3 * do, d)
        lin(b + "attn.proj", do, do)
        norm(b + "norm2", do)
        lin(b + "mlp.layers.0", hidden, do)
        lin(b + "mlp.layers.1", do, hidden)
        if d != do:
            lin(b + "proj", do, d)
    for j, e in enumerate(reversed(ends)):
        conv(f"image_encoder.neck.convs.{j}.conv", C, layout[e][1], 1)
    conv("mask_downsample", 1, 1, 4)
    for i in range(cfg["memattn_layers"]):
        l = f"memory_attention.layers.{i}."
        for a, kv in (("self_attn", C), ("cross_attn_image", M)):
            lin(l + a + ".q_proj", C, C)
            lin(l + a + ".k_proj", C, kv)
            lin(l + a + ".v_proj", C, kv)
            lin(l + a + ".out_proj", C, C)
        lin(l + "linear1", cfg["memattn_ffn"], C)
        lin(l + "linear2", C, cfg["memattn_ffn"])
        for n in (1, 2, 3):
            norm(f"{l}norm{n}", C)
    norm("memory_attention.norm", C)
    e = "memory_encoder."
    stride = cfg["mask_ds_stride"]
    layers = int(math.log2(cfg["mask_ds_total_stride"]) // math.log2(stride))
    cin = 1
    for j in range(layers):
        cout = cin * stride ** 2
        conv(f"{e}mask_downsampler.encoder.{3 * j}", cout, cin, cfg["mask_ds_kernel"])
        norm(f"{e}mask_downsampler.encoder.{3 * j + 1}", cout)
        cin = cout
    conv(f"{e}mask_downsampler.encoder.{3 * layers}", C, cin, 1)
    conv(e + "pix_feat_proj", C, C, 1)
    for i in range(cfg["fuser_layers"]):
        f = f"{e}fuser.layers.{i}."
        conv(f + "dwconv", C, C, cfg["fuser_kernel"], groups=C)
        norm(f + "norm", C)
        lin(f + "pwconv1", 4 * C, C)
        lin(f + "pwconv2", C, 4 * C)
        p(f + "gamma", C)
    conv(e + "out_proj", M, C, 1)
    p("maskmem_tpos_enc", cfg["num_maskmem"], 1, 1, M)
    p("no_mem_embed", 1, 1, C)
    p("no_mem_pos_enc", 1, 1, C)
    p("no_obj_ptr", 1, C)
    p("no_obj_embed_spatial", 1, M)
    for j in range(3):
        lin(f"obj_ptr_proj.layers.{j}", C, C)
    lin("obj_ptr_tpos_proj", M, C)
    pe = "sam_prompt_encoder."
    mi = cfg["mask_in_chans"]
    p(pe + "pe_layer.positional_encoding_gaussian_matrix", 2, C // 2)
    for i in range(4):
        p(f"{pe}point_embeddings.{i}.weight", 1, C)
    p(pe + "not_a_point_embed.weight", 1, C)
    p(pe + "mask_downscaling.0.weight", mi // 4, 1, 2, 2)
    p(pe + "mask_downscaling.0.bias", mi // 4)
    norm(pe + "mask_downscaling.1", mi // 4)
    p(pe + "mask_downscaling.3.weight", mi, mi // 4, 2, 2)
    p(pe + "mask_downscaling.3.bias", mi)
    norm(pe + "mask_downscaling.4", mi)
    conv(pe + "mask_downscaling.6", C, mi, 1)
    p(pe + "no_mask_embed.weight", 1, C)
    md = "sam_mask_decoder."
    inner = C // cfg["attention_downsample_rate"]

    def attn(key, width):
        lin(key + ".q_proj", width, C)
        lin(key + ".k_proj", width, C)
        lin(key + ".v_proj", width, C)
        lin(key + ".out_proj", C, width)

    for i in range(cfg["decoder_depth"]):
        l = f"{md}transformer.layers.{i}."
        attn(l + "self_attn", C)
        attn(l + "cross_attn_token_to_image", inner)
        attn(l + "cross_attn_image_to_token", inner)
        for n in (1, 2, 3, 4):
            norm(f"{l}norm{n}", C)
        lin(l + "mlp.lin1", cfg["decoder_mlp_dim"], C)
        lin(l + "mlp.lin2", C, cfg["decoder_mlp_dim"])
    attn(md + "transformer.final_attn_token_to_image", inner)
    norm(md + "transformer.norm_final_attn", C)
    T = cfg["num_multimask_outputs"] + 1
    p(md + "iou_token.weight", 1, C)
    p(md + "mask_tokens.weight", T, C)
    p(md + "obj_score_token.weight", 1, C)
    p(md + "output_upscaling.0.weight", C, C // 4, 2, 2)
    p(md + "output_upscaling.0.bias", C // 4)
    norm(md + "output_upscaling.1", C // 4)
    p(md + "output_upscaling.3.weight", C // 4, C // 8, 2, 2)
    p(md + "output_upscaling.3.bias", C // 8)
    conv(md + "conv_s0", C // 8, C, 1)
    conv(md + "conv_s1", C // 4, C, 1)
    for i in range(T):
        for j, (o, n) in enumerate(((C, C), (C, C), (C // 8, C))):
            lin(f"{md}output_hypernetworks_mlps.{i}.layers.{j}", o, n)
    h = cfg["iou_head_hidden_dim"]
    dims = [C] + [h] * (cfg["iou_head_depth"] - 1) + [T]
    for j in range(cfg["iou_head_depth"]):
        lin(f"{md}iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    for j, (o, n) in enumerate(((C, C), (C, C), (1, C))):
        lin(f"{md}pred_obj_score_head.layers.{j}", o, n)
    return out
