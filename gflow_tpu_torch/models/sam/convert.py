"""Segment Anything weights: the released checkpoints
(``sam_vit_h_4b8939.pth`` and its ViT-L / ViT-B siblings, a plain state
dict) load into ``SamModel`` as they are.

- ``expected_torch_keys``: the released key -> shape manifest, written out
  from the published layout (``build_sam.py``, ``modeling/``), for seeded
  weights (``models.random_weights``) and to check the model against;
- ``load_weights``: a released ``.pth`` -> a state dict of CPU tensors;
- ``config_for_state_dict``: the ``SamConfig`` a state dict fits.
"""
from __future__ import annotations

import re

import torch

from .model import SamConfig


def expected_torch_keys(c: SamConfig = SamConfig()) -> dict:
    """{released key: shape} of the model `c` describes."""
    E, C, p = c.encoder_embed_dim, c.prompt_embed_dim, c.patch_size
    grid = c.image_size // p
    hd = E // c.encoder_num_heads
    shapes = {
        "image_encoder.pos_embed": (1, grid, grid, E),
        "image_encoder.patch_embed.proj.weight": (E, 3, p, p),
        "image_encoder.patch_embed.proj.bias": (E,),
    }
    for i in range(c.encoder_depth):
        b = f"image_encoder.blocks.{i}"
        rows = 2 * (grid if i in c.encoder_global_attn_indexes else c.window_size) - 1
        shapes.update({
            f"{b}.norm1.weight": (E,), f"{b}.norm1.bias": (E,),
            f"{b}.attn.rel_pos_h": (rows, hd), f"{b}.attn.rel_pos_w": (rows, hd),
            f"{b}.attn.qkv.weight": (3 * E, E), f"{b}.attn.qkv.bias": (3 * E,),
            f"{b}.attn.proj.weight": (E, E), f"{b}.attn.proj.bias": (E,),
            f"{b}.norm2.weight": (E,), f"{b}.norm2.bias": (E,),
            f"{b}.mlp.lin1.weight": (c.mlp_ratio * E, E), f"{b}.mlp.lin1.bias": (c.mlp_ratio * E,),
            f"{b}.mlp.lin2.weight": (E, c.mlp_ratio * E), f"{b}.mlp.lin2.bias": (E,),
        })
    shapes.update({
        "image_encoder.neck.0.weight": (C, E, 1, 1),
        "image_encoder.neck.1.weight": (C,), "image_encoder.neck.1.bias": (C,),
        "image_encoder.neck.2.weight": (C, C, 3, 3),
        "image_encoder.neck.3.weight": (C,), "image_encoder.neck.3.bias": (C,),
    })
    m4, m = c.mask_in_chans // 4, c.mask_in_chans
    pe = "prompt_encoder"
    shapes[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = (2, C // 2)
    for i in range(4):
        shapes[f"{pe}.point_embeddings.{i}.weight"] = (1, C)
    shapes.update({
        f"{pe}.not_a_point_embed.weight": (1, C),
        f"{pe}.mask_downscaling.0.weight": (m4, 1, 2, 2), f"{pe}.mask_downscaling.0.bias": (m4,),
        f"{pe}.mask_downscaling.1.weight": (m4,), f"{pe}.mask_downscaling.1.bias": (m4,),
        f"{pe}.mask_downscaling.3.weight": (m, m4, 2, 2), f"{pe}.mask_downscaling.3.bias": (m,),
        f"{pe}.mask_downscaling.4.weight": (m,), f"{pe}.mask_downscaling.4.bias": (m,),
        f"{pe}.mask_downscaling.6.weight": (C, m, 1, 1), f"{pe}.mask_downscaling.6.bias": (C,),
        f"{pe}.no_mask_embed.weight": (1, C),
    })

    def attn(prefix, inner):
        shapes.update({f"{prefix}.q_proj.weight": (inner, C), f"{prefix}.q_proj.bias": (inner,),
                       f"{prefix}.k_proj.weight": (inner, C), f"{prefix}.k_proj.bias": (inner,),
                       f"{prefix}.v_proj.weight": (inner, C), f"{prefix}.v_proj.bias": (inner,),
                       f"{prefix}.out_proj.weight": (C, inner), f"{prefix}.out_proj.bias": (C,)})

    t = "mask_decoder.transformer"
    inner = C // c.attention_downsample_rate
    for i in range(c.decoder_depth):
        l = f"{t}.layers.{i}"
        attn(f"{l}.self_attn", C)
        attn(f"{l}.cross_attn_token_to_image", inner)
        attn(f"{l}.cross_attn_image_to_token", inner)
        for n in (1, 2, 3, 4):
            shapes[f"{l}.norm{n}.weight"] = (C,)
            shapes[f"{l}.norm{n}.bias"] = (C,)
        shapes.update({f"{l}.mlp.lin1.weight": (c.decoder_mlp_dim, C),
                       f"{l}.mlp.lin1.bias": (c.decoder_mlp_dim,),
                       f"{l}.mlp.lin2.weight": (C, c.decoder_mlp_dim), f"{l}.mlp.lin2.bias": (C,)})
    attn(f"{t}.final_attn_token_to_image", inner)
    shapes[f"{t}.norm_final_attn.weight"] = (C,)
    shapes[f"{t}.norm_final_attn.bias"] = (C,)
    md, T = "mask_decoder", c.num_multimask_outputs + 1
    shapes.update({
        f"{md}.iou_token.weight": (1, C), f"{md}.mask_tokens.weight": (T, C),
        f"{md}.output_upscaling.0.weight": (C, C // 4, 2, 2),
        f"{md}.output_upscaling.0.bias": (C // 4,),
        f"{md}.output_upscaling.1.weight": (C // 4,), f"{md}.output_upscaling.1.bias": (C // 4,),
        f"{md}.output_upscaling.3.weight": (C // 4, C // 8, 2, 2),
        f"{md}.output_upscaling.3.bias": (C // 8,),
    })

    def mlp(prefix, dims):
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{prefix}.layers.{j}.weight"] = (b, a)
            shapes[f"{prefix}.layers.{j}.bias"] = (b,)

    for i in range(T):
        mlp(f"{md}.output_hypernetworks_mlps.{i}", (C, C, C, C // 8))
    h = c.iou_head_hidden_dim
    mlp(f"{md}.iou_prediction_head", (C,) + (h,) * (c.iou_head_depth - 1) + (T,))
    return shapes


def load_weights(path) -> dict:
    """A released SAM ``.pth`` (a state dict, or one under ``"model"``)
    -> {key: float32 CPU tensor}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    return {k: v.float() for k, v in sd.items()}


def _count(keys, pattern) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in keys if (m := rx.match(k))})


def config_for_state_dict(sd: dict) -> SamConfig:
    """The SamConfig a released-layout state dict fits: widths, depths,
    patch, image and window sizes and the global blocks from its keys and
    shapes (a block whose relative-position table spans the whole grid
    attends globally). The decoder's heads are not in the keys: 8, as in
    every released model."""
    E, _, p, _ = sd["image_encoder.patch_embed.proj.weight"].shape
    grid = sd["image_encoder.pos_embed"].shape[1]
    depth = _count(sd, r"image_encoder\.blocks\.(\d+)\.")
    rows = [sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape for i in range(depth)]
    C = sd["image_encoder.neck.0.weight"].shape[0]
    hd = "mask_decoder.iou_prediction_head.layers"
    return SamConfig(
        encoder_embed_dim=E, encoder_depth=depth, encoder_num_heads=E // rows[0][1],
        encoder_global_attn_indexes=tuple(i for i, r in enumerate(rows) if r[0] == 2 * grid - 1),
        window_size=(min(r[0] for r in rows) + 1) // 2, patch_size=p, image_size=grid * p,
        mlp_ratio=sd["image_encoder.blocks.0.mlp.lin1.weight"].shape[0] // E,
        prompt_embed_dim=C,
        mask_in_chans=sd["prompt_encoder.mask_downscaling.3.weight"].shape[0],
        decoder_depth=_count(sd, r"mask_decoder\.transformer\.layers\.(\d+)\."),
        decoder_mlp_dim=sd["mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0],
        attention_downsample_rate=C // sd[
            "mask_decoder.transformer.final_attn_token_to_image.q_proj.weight"].shape[0],
        num_multimask_outputs=sd["mask_decoder.mask_tokens.weight"].shape[0] - 1,
        iou_head_depth=_count(sd, hd + r"\.(\d+)\."),
        iou_head_hidden_dim=sd[hd + ".0.weight"].shape[0])
