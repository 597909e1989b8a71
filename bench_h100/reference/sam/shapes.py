"""The released key layout of a SAM checkpoint (``sam_vit_h_4b8939.pth``
and its siblings), {key: shape}, from the published modules: what the
reference's forward reads, and what the benchmark's operation counts run
on (on the meta device)."""
from __future__ import annotations


def state_shapes(cfg: dict) -> dict:
    E, C, p = cfg["encoder_embed_dim"], cfg["prompt_embed_dim"], cfg["patch_size"]
    g, ws = cfg["image_size"] // p, cfg["window_size"]
    d, M = E // cfg["encoder_num_heads"], cfg["mlp_ratio"] * E
    out = {"image_encoder.pos_embed": (1, g, g, E),
           "image_encoder.patch_embed.proj.weight": (E, 3, p, p),
           "image_encoder.patch_embed.proj.bias": (E,)}

    def lin(key, o, i, bias=True):
        out[key + ".weight"] = (o, i)
        if bias:
            out[key + ".bias"] = (o,)

    def norm(key, n):
        out[key + ".weight"], out[key + ".bias"] = (n,), (n,)

    for i in range(cfg["encoder_depth"]):
        b = f"image_encoder.blocks.{i}."
        rows = 2 * (g if i in cfg["encoder_global_attn_indexes"] else ws) - 1
        norm(b + "norm1", E)
        out[b + "attn.rel_pos_h"] = out[b + "attn.rel_pos_w"] = (rows, d)
        lin(b + "attn.qkv", 3 * E, E)
        lin(b + "attn.proj", E, E)
        norm(b + "norm2", E)
        lin(b + "mlp.lin1", M, E)
        lin(b + "mlp.lin2", E, M)
    out["image_encoder.neck.0.weight"] = (C, E, 1, 1)
    norm("image_encoder.neck.1", C)
    out["image_encoder.neck.2.weight"] = (C, C, 3, 3)
    norm("image_encoder.neck.3", C)
    pe, m = "prompt_encoder.", cfg["mask_in_chans"]
    out[pe + "pe_layer.positional_encoding_gaussian_matrix"] = (2, C // 2)
    for i in range(4):
        out[f"{pe}point_embeddings.{i}.weight"] = (1, C)
    out[pe + "not_a_point_embed.weight"] = out[pe + "no_mask_embed.weight"] = (1, C)
    for k, o, i, kk in (("0", m // 4, 1, 2), ("3", m, m // 4, 2), ("6", C, m, 1)):
        out[f"{pe}mask_downscaling.{k}.weight"] = (o, i, kk, kk)
        out[f"{pe}mask_downscaling.{k}.bias"] = (o,)
    norm(pe + "mask_downscaling.1", m // 4)
    norm(pe + "mask_downscaling.4", m)
    t, inner = "mask_decoder.transformer.", C // cfg["attention_downsample_rate"]

    def attn(key, width):
        for n in ("q_proj", "k_proj", "v_proj"):
            lin(f"{key}.{n}", width, C)
        lin(key + ".out_proj", C, width)

    for i in range(cfg["decoder_depth"]):
        l = f"{t}layers.{i}."
        attn(l + "self_attn", C)
        attn(l + "cross_attn_token_to_image", inner)
        attn(l + "cross_attn_image_to_token", inner)
        for n in range(1, 5):
            norm(f"{l}norm{n}", C)
        lin(l + "mlp.lin1", cfg["decoder_mlp_dim"], C)
        lin(l + "mlp.lin2", C, cfg["decoder_mlp_dim"])
    attn(t + "final_attn_token_to_image", inner)
    norm(t + "norm_final_attn", C)
    md, T = "mask_decoder.", cfg["num_multimask_outputs"] + 1
    out[md + "iou_token.weight"], out[md + "mask_tokens.weight"] = (1, C), (T, C)
    out[md + "output_upscaling.0.weight"] = (C, C // 4, 2, 2)
    out[md + "output_upscaling.0.bias"] = (C // 4,)
    norm(md + "output_upscaling.1", C // 4)
    out[md + "output_upscaling.3.weight"] = (C // 4, C // 8, 2, 2)
    out[md + "output_upscaling.3.bias"] = (C // 8,)
    for i in range(T):
        for j, (o, n) in enumerate(((C, C), (C, C), (C // 8, C))):
            lin(f"{md}output_hypernetworks_mlps.{i}.layers.{j}", o, n)
    h, n = cfg["iou_head_hidden_dim"], cfg["iou_head_depth"]
    dims = [C] + [h] * (n - 1) + [T]
    for j in range(n):
        lin(f"{md}iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    return out
