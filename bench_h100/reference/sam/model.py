"""Segment Anything's forward written plainly from its published
description (``segment_anything/build_sam.py`` and ``modeling/``; arXiv
2304.02643), as functions of a released-key state dict: no modules, no
graphs, no kernels; float32 with TF32 off (``MODE`` "fp32"), or, for the
control, TF32 matrix products and convolutions ("tf32").

`cfg` holds the configuration's widths under the port's ``SamConfig``
names. Departures from upstream, each also the program's:

- the frame is resized on the device, bilinear with antialias on the
  float frame (upstream: PIL's resize of the uint8 frame);
- point coordinates are divided by the input size in float64 before the
  Fourier features (upstream does the same: its points are float64).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MODE = "fp32"  # "tf32": the control
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@contextlib.contextmanager
def precision():
    """TF32 off for "fp32", on for "tf32"; the caller's flags restored."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = MODE == "tf32"
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev


def input_size(h: int, w: int, long_side: int):
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _linear(sd, p, x):
    return F.linear(x, sd[p + ".weight"], sd.get(p + ".bias"))


def _layer_norm(sd, p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], eps)


def _layer_norm_2d(sd, p, x, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return sd[p + ".weight"][:, None, None] * x + sd[p + ".bias"][:, None, None]


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """Rows rel_pos[q - k + k_size - 1] for each query q and key k."""
    q = torch.arange(q_size, device=rel_pos.device)[:, None]
    k = torch.arange(k_size, device=rel_pos.device)[None, :]
    return rel_pos[(q - k + (k_size - 1)).long()]


def vit_attention(sd, p, x, heads: int):
    """Self-attention over a (B, H, W, C) grid with the decomposed
    relative-position bias (upstream's ``Attention`` and
    ``add_decomposed_rel_pos``)."""
    B, H, W, C = x.shape
    qkv = _linear(sd, p + ".qkv", x).reshape(B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    d = q.shape[-1]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    Rh = get_rel_pos(H, H, sd[p + ".rel_pos_h"])
    Rw = get_rel_pos(W, W, sd[p + ".rel_pos_w"])
    r_q = q.reshape(B * heads, H, W, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B * heads, H, W, H, W) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B * heads, H * W, H * W)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    return _linear(sd, p + ".proj", x)


def vit_block(sd, p, x, heads: int, window: int):
    shortcut = x
    x = _layer_norm(sd, p + ".norm1", x, 1e-6)
    if window > 0:
        B, H, W, C = x.shape
        ph, pw = (window - H % window) % window, (window - W % window) % window
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        x = x.view(B, Hp // window, window, Wp // window, window, C)
        x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, C)
        x = vit_attention(sd, p + ".attn", x, heads)
        x = x.view(B, Hp // window, Wp // window, window, window, -1)
        x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)[:, :H, :W, :]
    else:
        x = vit_attention(sd, p + ".attn", x, heads)
    x = shortcut + x
    y = _layer_norm(sd, p + ".norm2", x, 1e-6)
    return x + _linear(sd, p + ".mlp.lin2", F.gelu(_linear(sd, p + ".mlp.lin1", y)))


def embed(cfg: dict, sd: dict, frame):
    """(H, W, 3) frame, 0-255 -> the image embedding (1, C, g, g)."""
    with precision():
        S = cfg["image_size"]
        H, W = frame.shape[:2]
        h, w = input_size(H, W, S)
        x = frame.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, (h, w), mode="bilinear", align_corners=False, antialias=True)
        mean = torch.tensor(PIXEL_MEAN, device=x.device).view(-1, 1, 1)
        std = torch.tensor(PIXEL_STD, device=x.device).view(-1, 1, 1)
        x = F.pad((x - mean) / std, (0, S - w, 0, S - h))
        e = "image_encoder"
        p = cfg["patch_size"]
        x = F.conv2d(x, sd[e + ".patch_embed.proj.weight"], sd[e + ".patch_embed.proj.bias"],
                     stride=p).permute(0, 2, 3, 1)
        x = x + sd[e + ".pos_embed"]
        for i in range(cfg["encoder_depth"]):
            window = 0 if i in cfg["encoder_global_attn_indexes"] else cfg["window_size"]
            x = vit_block(sd, f"{e}.blocks.{i}", x, cfg["encoder_num_heads"], window)
        x = x.permute(0, 3, 1, 2)
        x = _layer_norm_2d(sd, e + ".neck.1", F.conv2d(x, sd[e + ".neck.0.weight"]))
        x = F.conv2d(x, sd[e + ".neck.2.weight"], padding=1)
        return _layer_norm_2d(sd, e + ".neck.3", x)


def _pe(sd, coords):
    """Random Fourier features of coordinates in [0, 1]."""
    g = sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = 2 * math.pi * ((2 * coords - 1) @ g)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def prompt_embeddings(cfg: dict, sd: dict, points):
    """Positive points (B, N, 2) in input pixels -> sparse (B, N + 1, C)
    with the padding point, dense (B, C, g, g), image PE (1, C, g, g)."""
    pe = "prompt_encoder"
    S, g = cfg["image_size"], cfg["image_size"] // cfg["patch_size"]
    B, N, _ = points.shape
    coords = torch.cat([points + 0.5, torch.zeros_like(points[:, :1])], dim=1) / S
    labels = torch.cat([torch.ones(B, N, device=points.device),
                        -torch.ones(B, 1, device=points.device)], dim=1)
    emb = _pe(sd, coords.float())
    pad = (labels == -1)[..., None]
    emb = torch.where(pad, sd[pe + ".not_a_point_embed.weight"],
                      emb + sd[pe + ".point_embeddings.1.weight"])
    dense = sd[pe + ".no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(B, -1, g, g)
    ys = (torch.arange(g, device=points.device, dtype=torch.float32) + 0.5) / g
    grid = torch.stack(torch.meshgrid(ys, ys, indexing="ij")[::-1], dim=-1)  # (x, y)
    return emb, dense, _pe(sd, grid).permute(2, 0, 1)[None]


def _attention(sd, p, q, k, v, heads: int):
    """The decoder's attention (upstream ``transformer.Attention``)."""
    q, k, v = (_linear(sd, p + n, t) for n, t in (("q_proj", q), ("k_proj", k), ("v_proj", v)))
    sep = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
    q, k, v = sep(q), sep(k), sep(v)
    attn = torch.softmax(q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1]), dim=-1)
    out = (attn @ v).transpose(1, 2)
    return _linear(sd, p + "out_proj", out.reshape(out.shape[0], out.shape[1], -1))


def _mlp(sd, p, x, n: int):
    for i in range(n):
        x = _linear(sd, f"{p}.layers.{i}", x)
        x = F.relu(x) if i < n - 1 else x
    return x


def decode(cfg: dict, sd: dict, embedding, points):
    """Positive points (B, 1, 2) in input pixels -> multimask logits (B,
    3, 4g, 4g) and IoUs (B, 3)."""
    with precision():
        sparse, dense, image_pe = prompt_embeddings(cfg, sd, points)
        md, heads = "mask_decoder", cfg["decoder_num_heads"]
        t = md + ".transformer"
        B = sparse.shape[0]
        out_tokens = torch.cat([sd[md + ".iou_token.weight"], sd[md + ".mask_tokens.weight"]])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], dim=1)
        src = torch.repeat_interleave(embedding, B, dim=0) + dense
        pos = torch.repeat_interleave(image_pe, B, dim=0)
        b, c, h, w = src.shape
        keys = src.flatten(2).permute(0, 2, 1)
        key_pe = pos.flatten(2).permute(0, 2, 1)
        queries = tokens
        for i in range(cfg["decoder_depth"]):
            l = f"{t}.layers.{i}."
            if i == 0:
                queries = _attention(sd, l + "self_attn.", queries, queries, queries, heads)
            else:
                q = queries + tokens
                queries = queries + _attention(sd, l + "self_attn.", q, q, queries, heads)
            queries = _layer_norm(sd, l + "norm1", queries, 1e-5)
            q, k = queries + tokens, keys + key_pe
            queries = queries + _attention(sd, l + "cross_attn_token_to_image.", q, k, keys, heads)
            queries = _layer_norm(sd, l + "norm2", queries, 1e-5)
            mlp = _linear(sd, l + "mlp.lin2", F.relu(_linear(sd, l + "mlp.lin1", queries)))
            queries = _layer_norm(sd, l + "norm3", queries + mlp, 1e-5)
            q, k = queries + tokens, keys + key_pe
            keys = keys + _attention(sd, l + "cross_attn_image_to_token.", k, q, queries, heads)
            keys = _layer_norm(sd, l + "norm4", keys, 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = queries + _attention(sd, t + ".final_attn_token_to_image.", q, k, keys, heads)
        hs = _layer_norm(sd, t + ".norm_final_attn", queries, 1e-5)
        up = md + ".output_upscaling"
        x = keys.transpose(1, 2).reshape(b, c, h, w)
        x = F.conv_transpose2d(x, sd[up + ".0.weight"], sd[up + ".0.bias"], stride=2)
        x = F.gelu(_layer_norm_2d(sd, up + ".1", x))
        x = F.gelu(F.conv_transpose2d(x, sd[up + ".3.weight"], sd[up + ".3.bias"], stride=2))
        T = cfg["num_multimask_outputs"] + 1
        hyper = torch.stack([_mlp(sd, f"{md}.output_hypernetworks_mlps.{i}", hs[:, 1 + i], 3)
                             for i in range(T)], dim=1)
        _, cu, hu, wu = x.shape
        masks = (hyper @ x.view(b, cu, hu * wu)).view(b, -1, hu, wu)
        iou = _mlp(sd, md + ".iou_prediction_head", hs[:, 0], cfg["iou_head_depth"])
        return masks[:, 1:], iou[:, 1:]
