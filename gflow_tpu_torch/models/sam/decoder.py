"""SAM's prompt encoder and mask decoder (``segment_anything/modeling/
prompt_encoder.py``, ``mask_decoder.py``, ``transformer.py``).

- ``PromptEncoder``: points as random Fourier features of their position
  plus a learned embedding of their label; without a box a padding point
  (label -1) is appended; with no mask input the dense embedding is
  ``no_mask_embed`` over the whole grid, with one (SAM 2's prompted frame)
  ``mask_downscaling`` of the mask.
- ``MaskDecoder``: the two-way transformer between the prompt tokens
  ([iou, 4 mask tokens, sparse]) and the image embedding, one for all
  prompts or one each, the transposed-convolution upscaler, a
  hypernetwork MLP per mask token and the IoU head. The configuration's
  ``sam2_heads`` turns on SAM 2.1's parts (``sam2/modeling/sam/
  mask_decoder.py`` with ``pred_obj_scores``, ``pred_obj_scores_mlp``,
  ``use_high_res_features`` and ``iou_prediction_use_sigmoid``): an
  object-score token before the others and its MLP head, the
  high-resolution skips ``conv_s0`` / ``conv_s1`` added into the upscaler
  and a sigmoid on the IoU head.

The transformer's image stream is kept as contiguous (B, h*w, C) token
rows: ``ops/sam_decoder.py`` makes them (``stream_init``), runs both
cross-attentions between the projections (``t2i_attend``, ``i2t_attend``)
and the residual norm (``residual_ln``), hand-written kernels on the card
and upstream's formula on the CPU. ``keys + key_pe`` is made once after
each change of the keys (upstream recomputes it for every attention that
reads it): the same values.

Modules are named after the released keys under ``prompt_encoder.`` and
``mask_decoder.``. Every operation has a fixed shape and no host
synchronisation (labels select embeddings through ``torch.where``), so a
decode can be recorded as one CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sam_decoder
from .image_encoder import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier features: PE(c) = [sin(2 pi (2c - 1) G), cos(...)]
    for coordinates c in [0, 1]^2 (x, y) and the (2, F) Gaussian matrix
    G."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords):
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int):
        """(C, h, w): PE of the cell centres ((j + 0.5) / w, (i + 0.5) / h)."""
        g = self.positional_encoding_gaussian_matrix
        y = (torch.arange(h, device=g.device, dtype=g.dtype) + 0.5) / h
        x = (torch.arange(w, device=g.device, dtype=g.dtype) + 0.5) / w
        xy = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)
        return self.encode(xy).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, dim: int, grid: int, image_size: int, mask_in_chans: int):
        super().__init__()
        self.grid, self.image_size = grid, image_size
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2), LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2), LayerNorm2d(mask_in_chans),
            nn.GELU(), nn.Conv2d(mask_in_chans, dim, 1))
        self.no_mask_embed = nn.Embedding(1, dim)

    def sparse(self, points, labels):
        """(B, N, 2) pixel coordinates (x, y) in the padded input frame,
        (B, N) labels (1 positive, 0 negative) -> (B, N + 1, C): each point
        at its pixel's centre, the padding point appended."""
        B = points.shape[0]
        pts = torch.cat([points + 0.5, points.new_zeros(B, 1, 2)], dim=1) / self.image_size
        lab = torch.cat([labels, labels.new_full((B, 1), -1)], dim=1)[..., None]
        pe = self.pe_layer.encode(pts.to(self.pe_layer.positional_encoding_gaussian_matrix))
        pe = torch.where(lab == -1, 0.0, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed.weight, 0.0)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight, 0.0)
        return pe + torch.where(lab == 1, self.point_embeddings[1].weight, 0.0)

    def dense(self, masks=None):
        """The dense prompt: without a mask input (C,), the same at every
        cell of the grid (upstream expands it to (B, C, h, w)); of masks
        (B, 1, 4h, 4w) their embedding (B, C, h, w)."""
        if masks is None:
            return self.no_mask_embed.weight[0]
        return self.mask_downscaling(masks)

    def image_pe(self):
        return self.pe_layer.grid(self.grid, self.grid)[None]


class DecoderAttention(nn.Module):
    """Attention with projections to an internal width of dim /
    downsample_rate."""

    def __init__(self, dim: int, heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v, attend_fn=sam_decoder.cross_attend_plain):
        """out_proj(attend_fn(q_proj(q), k_proj(k), v_proj(v), heads)): the
        attention on the merged-head projections; the image stream's
        kernels take the cross attentions, the tokens' self-attention the
        plain version."""
        return self.out_proj(attend_fn(self.q_proj(q), self.k_proj(k), self.v_proj(v),
                                       self.heads))


class TokenMLP(nn.Module):
    """lin2(ReLU(lin1(x)))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    """Self-attention of the tokens, tokens to image, MLP, image to tokens;
    a post-norm after each (LayerNorm eps 1e-5). The first block's
    self-attention replaces the tokens, without their PE or a residual.
    The image stream comes in and goes out as keys and kpe = keys + key_pe
    (B, N, C)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, downsample_rate: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, downsample_rate)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = TokenMLP(dim, mlp_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, downsample_rate)

    def forward(self, queries, keys, kpe, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            queries + query_pe, kpe, keys, sam_decoder.t2i_attend))
        queries = self.norm3(queries + self.mlp(queries))
        out = self.cross_attn_image_to_token(kpe, queries + query_pe, queries,
                                             sam_decoder.i2t_attend)
        n = self.norm4
        keys, kpe = sam_decoder.residual_ln(keys, out, n.weight, n.bias, n.eps, key_pe)
        return queries, keys, kpe


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, heads: int, mlp_dim: int, downsample_rate: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, heads, mlp_dim, downsample_rate, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = DecoderAttention(dim, heads, downsample_rate)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image, image_pe, tokens, dense):
        """image (1 or B, C, h, w), image_pe (1, C, h, w); tokens (B, T, C);
        dense (C,), added to the image at every cell, or (B, C, h, w) ->
        (tokens, image as (B, h*w, C))."""
        # (N, C) token rows: the prompt encoder's grid PE is laid out so
        # already, and is not copied
        key_pe = image_pe[0].flatten(1).t().contiguous()
        keys, kpe = sam_decoder.stream_init(image, dense, key_pe, tokens.shape[0])
        queries = tokens
        for layer in self.layers:
            queries, keys, kpe = layer(queries, keys, kpe, tokens, key_pe)
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(
            queries + tokens, kpe, keys, sam_decoder.t2i_attend))
        return queries, keys


class HeadMLP(nn.Module):
    """Linear layers with ReLU between them (``layers.{i}``)."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int, depth: int):
        super().__init__()
        dims = [dim_in] + [hidden] * (depth - 1) + [dim_out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        dim = c.prompt_embed_dim
        self.num_mask_tokens = c.num_multimask_outputs + 1
        self.sam2_heads = c.sam2_heads
        self.transformer = TwoWayTransformer(c.decoder_depth, dim, c.decoder_num_heads,
                                             c.decoder_mlp_dim, c.attention_downsample_rate)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        if c.sam2_heads:
            self.obj_score_token = nn.Embedding(1, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU())
        if c.sam2_heads:
            self.conv_s0 = nn.Conv2d(dim, dim // 8, 1)
            self.conv_s1 = nn.Conv2d(dim, dim // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            HeadMLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = HeadMLP(dim, c.iou_head_hidden_dim, self.num_mask_tokens,
                                           c.iou_head_depth)
        if c.sam2_heads:
            self.pred_obj_score_head = HeadMLP(dim, dim, 1, 3)

    def forward(self, image_embedding, image_pe, sparse, dense, high_res=None):
        """image_embedding (1 or B, C, h, w), image_pe (1, C, h, w); sparse
        (B, N, C); dense (C,) or (B, C, h, w); with the high-resolution
        skips, high_res = (feat_s0 (1 or B, C/8, 4h, 4w), feat_s1 (1 or B,
        C/4, 2h, 2w)), the FPN levels through ``conv_s0`` / ``conv_s1`` ->
        all masks (B, 4, 4h, 4w), IoUs (B, 4), the mask tokens' outputs (B,
        4, C) and the object-score logits (B, 1) (None without them)."""
        B = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        if self.sam2_heads:
            out_tokens = torch.cat([self.obj_score_token.weight, out_tokens], dim=0)
        s = int(self.sam2_heads)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], dim=1)
        _, c, h, w = image_embedding.shape
        hs, src = self.transformer(image_embedding, image_pe, tokens, dense)
        mask_out = hs[:, s + 1:s + 1 + self.num_mask_tokens]
        src = src.transpose(1, 2).reshape(B, c, h, w)
        if high_res is None:
            up = self.output_upscaling(src)
        else:
            dc1, ln1, act1, dc2, act2 = self.output_upscaling
            feat_s0, feat_s1 = high_res
            up = act2(dc2(act1(ln1(dc1(src) + feat_s1))) + feat_s0)
        hyper = torch.stack([mlp(mask_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, cu, hu, wu = up.shape
        masks = (hyper @ up.reshape(b, cu, hu * wu)).reshape(b, -1, hu, wu)
        iou = self.iou_prediction_head(hs[:, s])
        if self.sam2_heads:
            iou = torch.sigmoid(iou)
        score = self.pred_obj_score_head(hs[:, 0]) if self.sam2_heads else None
        return masks, iou, mask_out, score
