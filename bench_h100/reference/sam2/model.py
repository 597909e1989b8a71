"""SAM 2.1's video step written plainly from its published modules
(``sam2/modeling/backbones/hieradet.py``, ``image_encoder.py``,
``memory_attention.py``, ``memory_encoder.py``, ``sam/transformer.py``,
``sam/mask_decoder.py``, ``sam/prompt_encoder.py``, ``sam2_base.py``,
``sam2_video_predictor.py``; arXiv 2408.00714), as functions of a
released-key state dict: no modules, no graphs, no kernels, no batching
across frames; float32 with TF32 off (``MODE`` "fp32"), or, for the
control, TF32 matrix products and convolutions ("tf32").

`cfg` holds the configuration's widths under the port's ``Sam2Config``
names. The memory bank is upstream's: a dict of each frame's outputs, the
memories chosen by ``_prepare_memory_conditioned_features``'s rule and
concatenated in its order (the prompted frame, then the oldest to the
newest), the pointers the same. Attention is written out (scores, softmax,
values); RoPE as upstream's complex product (``apply_rotary_enc``).

Departures from upstream, each also the program's:

- the frame is resized on the device, bilinear with antialias on the float
  frame (upstream: PIL's resize of the uint8 frame);
- the memories are kept in float32 (upstream's video predictor stores
  them in bfloat16);
- no hole filling (``fill_hole_area``; upstream skips it when its
  extension is not built).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MODE = "fp32"  # "tf32": the control
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NO_OBJ_SCORE = -1024.0


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


def _lin(sd, p, x):
    return F.linear(x, sd[p + ".weight"], sd.get(p + ".bias"))


def _ln(sd, p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], eps)


def _ln2d(sd, p, x, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return sd[p + ".weight"][:, None, None] * x + sd[p + ".bias"][:, None, None]


def _conv(sd, p, x, **kw):
    return F.conv2d(x, sd[p + ".weight"], sd.get(p + ".bias"), **kw)


def _mlp(sd, p, x, n, act=F.relu, sigmoid=False):
    for i in range(n):
        x = _lin(sd, f"{p}.layers.{i}", x)
        x = act(x) if i < n - 1 else x
    return torch.sigmoid(x) if sigmoid else x


def _sdpa(q, k, v):
    """(B, h, Nq, d) x (B, h, Nk, d): softmax(q k^T / sqrt(d)) v."""
    attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    return torch.softmax(attn, dim=-1) @ v


# --- the image encoder --------------------------------------------------------

def stage_layout(cfg):
    """Hiera's blocks as upstream's constructor lays them out: (dim, dim_out,
    heads, q_stride, window) each, and the stages' last blocks."""
    stages = cfg["stages"]
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    q_pool_blocks = [x + 1 for x in ends[:-1]][:cfg["q_pool"]]
    dim, heads, cur, out = cfg["embed_dim"], cfg["num_heads"], 1, []
    for i in range(sum(stages)):
        dim_out = dim
        window = cfg["window_spec"][cur - 1]
        window = 0 if i in cfg["global_att_blocks"] else window
        if i - 1 in ends:
            dim_out = int(dim * cfg["dim_mul"])
            heads = int(heads * cfg["head_mul"])
            cur += 1
        out.append((dim, dim_out, heads, cfg["q_stride"] if i in q_pool_blocks else 0, window))
        dim = dim_out
    return out, ends


def window_partition(x, ws):
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def _pool(x, s):
    return F.max_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)


def hiera_block(sd, p, x, dim, dim_out, heads, q_stride, window):
    shortcut = x
    x = _ln(sd, p + ".norm1", x, 1e-6)
    if dim != dim_out:
        shortcut = _lin(sd, p + ".proj", x)
        if q_stride:
            shortcut = _pool(shortcut, q_stride)
    ws = window
    if ws > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, ws)
    B, h, w, _ = x.shape
    qkv = _lin(sd, p + ".attn.qkv", x).reshape(B, h * w, 3, heads, -1)
    q, k, v = torch.unbind(qkv, 2)
    if q_stride:
        q = _pool(q.reshape(B, h, w, -1), q_stride)
        h, w = q.shape[1:3]
        q = q.reshape(B, h * w, heads, -1)
    x = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    x = _lin(sd, p + ".attn.proj", x.reshape(B, h, w, -1))
    if q_stride:
        ws = window // q_stride
        H, W = shortcut.shape[1:3]
        pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws)
    if window > 0:
        x = window_unpartition(x, ws, pad_hw, (H, W))
    x = shortcut + x
    y = _ln(sd, p + ".norm2", x, 1e-6)
    return x + _mlp(sd, p + ".mlp", y, 2, act=F.gelu)


def sine_pe(num_pos_feats, h, w, device, temperature=10000.0):
    """``PositionEmbeddingSine`` (normalize, scale 2 pi) of an h x w map:
    (1, num_pos_feats, h, w)."""
    npf = num_pos_feats // 2
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device).view(1, -1, 1)
    y_embed = y_embed.repeat(1, 1, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device).view(1, 1, -1)
    x_embed = x_embed.repeat(1, h, 1)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def hiera_pos_embed(sd, hw):
    t = "image_encoder.trunk"
    pos = F.interpolate(sd[t + ".pos_embed"], size=hw, mode="bicubic")
    win = sd[t + ".pos_embed_window"]
    pos = pos + win.tile([x // y for x, y in zip(pos.shape, win.shape)])
    return pos.permute(0, 2, 3, 1)


def encode(cfg, sd, frame):
    """(H, W, 3) frame, 0-255 -> {"s0", "s1": the two finer FPN levels
    through conv_s0 / conv_s1; "feat": the coarsest kept level; "pos": its
    sine PE} (``forward_image``)."""
    with precision():
        S = cfg["image_size"]
        x = frame.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, (S, S), mode="bilinear", align_corners=False, antialias=True) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(-1, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=x.device).view(-1, 1, 1)
        x = (x - mean) / std
        t = "image_encoder.trunk"
        x = _conv(sd, t + ".patch_embed.proj", x, stride=4, padding=3).permute(0, 2, 3, 1)
        x = x + hiera_pos_embed(sd, x.shape[1:3])
        layout, ends = stage_layout(cfg)
        outs = []
        for i, spec in enumerate(layout):
            x = hiera_block(sd, f"{t}.blocks.{i}", x, *spec)
            if i in ends:
                outs.append(x.permute(0, 3, 1, 2))
        n = len(outs) - 1
        feats, prev = [None] * len(outs), None
        for i in range(n, -1, -1):
            lateral = _conv(sd, f"image_encoder.neck.convs.{n - i}.conv", outs[i])
            if i in cfg["fpn_top_down_levels"] and prev is not None:
                top = F.interpolate(prev.to(dtype=torch.float32), scale_factor=2.0,
                                    mode="nearest", align_corners=None, antialias=False)
                prev = lateral + top
            else:
                prev = lateral
            feats[i] = prev
        feats = feats[:len(feats) - cfg["scalp"]]
        md = "sam_mask_decoder"
        return {"s0": _conv(sd, md + ".conv_s0", feats[0]),
                "s1": _conv(sd, md + ".conv_s1", feats[1]), "feat": feats[-1],
                "pos": sine_pe(cfg["d_model"], *feats[-1].shape[-2:], feats[-1].device)}


# --- the SAM heads -----------------------------------------------------------

def _pe_coords(sd, coords):
    g = sd["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = 2 * math.pi * ((2 * coords - 1) @ g)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(sd, grid, device):
    ys = (torch.arange(grid, device=device, dtype=torch.float32) + 0.5) / grid
    xy = torch.stack(torch.meshgrid(ys, ys, indexing="ij")[::-1], dim=-1)
    return _pe_coords(sd, xy).permute(2, 0, 1)[None]


def prompt_encoder(cfg, sd, B, masks, grid, device):
    """No points (upstream pads an empty point, label -1, and, without a
    box, one more), and the mask prompt `masks` (B, 1, 4g, 4g) or None ->
    sparse (B, 2, C), dense (B, C, g, g)."""
    pe = "sam_prompt_encoder"
    C = cfg["d_model"]
    sparse = sd[pe + ".not_a_point_embed.weight"].reshape(1, 1, C).expand(B, 2, C)
    if masks is None:
        dense = sd[pe + ".no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(B, -1, grid, grid)
    else:
        m = pe + ".mask_downscaling"
        x = F.gelu(_ln2d(sd, m + ".1", _conv(sd, m + ".0", masks, stride=2)))
        x = F.gelu(_ln2d(sd, m + ".4", _conv(sd, m + ".3", x, stride=2)))
        dense = _conv(sd, m + ".6", x)
    return sparse, dense


def _attention(sd, p, q, k, v, heads):
    q, k, v = (_lin(sd, p + n, t) for n, t in (("q_proj", q), ("k_proj", k), ("v_proj", v)))
    sep = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
    out = _sdpa(sep(q), sep(k), sep(v)).transpose(1, 2)
    return _lin(sd, p + "out_proj", out.reshape(out.shape[0], out.shape[1], -1))


def mask_decoder(cfg, sd, image, sparse, dense, s0, s1):
    """image (B, C, g, g) (the image already batched: repeat_image False),
    high-res skips s0, s1 -> all masks (B, 4, 4g, 4g), IoUs (B, 4) through
    the sigmoid, the mask tokens' outputs (B, 4, C), object scores (B, 1)."""
    md, heads = "sam_mask_decoder", cfg["decoder_num_heads"]
    t = md + ".transformer"
    B = sparse.shape[0]
    out_tokens = torch.cat([sd[md + ".obj_score_token.weight"], sd[md + ".iou_token.weight"],
                            sd[md + ".mask_tokens.weight"]], dim=0)
    tokens = torch.cat((out_tokens[None].expand(B, -1, -1), sparse), dim=1)
    src = image + dense
    pos = torch.repeat_interleave(dense_pe(sd, image.shape[-1], image.device), B, dim=0)
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
        queries = _ln(sd, l + "norm1", queries, 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = queries + _attention(sd, l + "cross_attn_token_to_image.", q, k, keys, heads)
        queries = _ln(sd, l + "norm2", queries, 1e-5)
        mlp = _lin(sd, l + "mlp.lin2", F.relu(_lin(sd, l + "mlp.lin1", queries)))
        queries = _ln(sd, l + "norm3", queries + mlp, 1e-5)
        q, k = queries + tokens, keys + key_pe
        keys = keys + _attention(sd, l + "cross_attn_image_to_token.", k, q, queries, heads)
        keys = _ln(sd, l + "norm4", keys, 1e-5)
    q, k = queries + tokens, keys + key_pe
    queries = queries + _attention(sd, t + ".final_attn_token_to_image.", q, k, keys, heads)
    hs = _ln(sd, t + ".norm_final_attn", queries, 1e-5)
    T = cfg["num_multimask_outputs"] + 1
    mask_tokens_out = hs[:, 2:2 + T]
    up = md + ".output_upscaling"
    x = keys.transpose(1, 2).reshape(b, c, h, w)
    x = _ln2d(sd, up + ".1", F.conv_transpose2d(x, sd[up + ".0.weight"], sd[up + ".0.bias"],
                                                 stride=2) + s1)
    x = F.gelu(x)
    x = F.gelu(F.conv_transpose2d(x, sd[up + ".3.weight"], sd[up + ".3.bias"], stride=2) + s0)
    hyper = torch.stack([_mlp(sd, f"{md}.output_hypernetworks_mlps.{i}", mask_tokens_out[:, i], 3)
                         for i in range(T)], dim=1)
    _, cu, hu, wu = x.shape
    masks = (hyper @ x.view(b, cu, hu * wu)).view(b, -1, hu, wu)
    iou = _mlp(sd, md + ".iou_prediction_head", hs[:, 1], cfg["iou_head_depth"], sigmoid=True)
    score = _mlp(sd, md + ".pred_obj_score_head", hs[:, 0], 3)
    return masks, iou, mask_tokens_out, score


def obj_ptr(sd, token, present):
    """``_forward_sam_heads``' pointer: obj_ptr_proj, times presence, plus
    no_obj_ptr where absent (``fixed_no_obj_ptr``)."""
    ptr = _mlp(sd, "obj_ptr_proj", token, 3)
    lam = present.float()
    return lam * ptr + (1 - lam) * sd["no_obj_ptr"]


def sam_heads(cfg, sd, image, s0, s1, mask_inputs=None, multimask=True, choose=None):
    """``_forward_sam_heads`` without points: -> dict of the decoder's raw
    outputs and the chosen low-res / high-res masks and pointer. `choose`
    = (best index into masks 1-3 (B,), presence (B, 1)) takes those
    discrete choices from the caller (the program's), so that a tie within
    rounding cannot flip them here; by default they are this run's."""
    with precision():
        B, S, g = image.shape[0], cfg["image_size"], image.shape[-1]
        sparse, dense = prompt_encoder(cfg, sd, B, mask_inputs, g, image.device)
        masks, iou, tokens, score = mask_decoder(cfg, sd, image, sparse, dense, s0, s1)
        out = {"masks": masks, "iou": iou, "score": score}
        if multimask:
            low_multi, ious, toks = masks[:, 1:], iou[:, 1:], tokens[:, 1:]
        else:
            low_multi, ious, toks = masks[:, 0:1], iou[:, 0:1], tokens[:, 0:1]
        present = score > 0 if choose is None else choose[1]
        low_multi = torch.where(present[:, None, None], low_multi, NO_OBJ_SCORE)
        high_multi = F.interpolate(low_multi, size=(S, S), mode="bilinear", align_corners=False)
        rows = torch.arange(B, device=image.device)
        if multimask:
            best = torch.argmax(ious, dim=-1) if choose is None else choose[0]
            out["low"] = low_multi[rows, best].unsqueeze(1)
            out["high"] = high_multi[rows, best].unsqueeze(1)
            token = toks[rows, best]
        else:
            out["low"], out["high"], token = low_multi, high_multi, toks[:, 0]
        out["ptr"] = obj_ptr(sd, token, present)
        out["present"] = present
        return out


def use_mask_as_output(cfg, sd, feat, s0, s1, masks):
    """The prompted frame (``_use_mask_as_output``): masks (B, 1, S, S) 0/1
    -> low-res logits, pointer, object scores."""
    with precision():
        S = cfg["image_size"]
        high = masks.float() * 20.0 - 10.0
        low = F.interpolate(high, size=(S // 4, S // 4), align_corners=False, mode="bilinear",
                            antialias=True)
        down = _conv(sd, "mask_downsample", masks.float(), stride=4)
        B = masks.shape[0]
        image = feat.expand(B, -1, -1, -1)
        ptr = sam_heads(cfg, sd, image, s0.expand(B, -1, -1, -1), s1.expand(B, -1, -1, -1),
                        mask_inputs=down, multimask=False)["ptr"]
        lam = torch.any(masks.flatten(1).float() > 0.0, dim=1)[..., None].float()
        ptr = lam * ptr + (1 - lam) * sd["no_obj_ptr"]
        return {"low": low, "ptr": ptr, "score": 20.0 * lam - 10.0}


# --- the memory ---------------------------------------------------------------

def encode_memory(cfg, sd, pix_feat, high_res, score, from_pts):
    """``_encode_new_memory`` and the memory encoder: pix_feat (B, C, g, g),
    the mask's logits at image size (B, 1, S, S) -> (memory (B, mem_dim,
    g, g), its sine PE)."""
    with precision():
        if from_pts:
            m = (high_res > 0).float()
        else:
            m = torch.sigmoid(high_res)
        m = m * cfg["sigmoid_scale_for_mem_enc"] + cfg["sigmoid_bias_for_mem_enc"]
        e = "memory_encoder"
        stride, kernel, pad = cfg["mask_ds_stride"], cfg["mask_ds_kernel"], cfg["mask_ds_padding"]
        layers = int(math.log2(cfg["mask_ds_total_stride"]) // math.log2(stride))
        x = m
        for j in range(layers):
            p = f"{e}.mask_downsampler.encoder.{3 * j}"
            x = _conv(sd, p, x, stride=stride, padding=pad)
            x = F.gelu(_ln2d(sd, f"{e}.mask_downsampler.encoder.{3 * j + 1}", x))
        x = _conv(sd, f"{e}.mask_downsampler.encoder.{3 * layers}", x)
        x = _conv(sd, e + ".pix_feat_proj", pix_feat) + x
        for i in range(cfg["fuser_layers"]):
            f = f"{e}.fuser.layers.{i}"
            inp = x
            y = F.conv2d(x, sd[f + ".dwconv.weight"], sd[f + ".dwconv.bias"],
                         padding=cfg["fuser_kernel"] // 2, groups=x.shape[1])
            y = _ln2d(sd, f + ".norm", y).permute(0, 2, 3, 1)
            y = _lin(sd, f + ".pwconv2", F.gelu(_lin(sd, f + ".pwconv1", y)))
            x = inp + (sd[f + ".gamma"] * y).permute(0, 3, 1, 2)
        x = _conv(sd, e + ".out_proj", x)
        present = (score > 0).float()
        x = x + (1 - present[..., None, None]) * sd["no_obj_embed_spatial"][..., None, None]
        return x, sine_pe(x.shape[1], x.shape[-2], x.shape[-1], x.device).repeat(x.shape[0], 1, 1, 1)


def compute_axial_cis(dim, end_x, end_y, theta=10000.0, device=None):
    freqs_x = 1.0 / (theta ** (torch.arange(0, dim, 4, device=device)[: (dim // 4)].float() / dim))
    freqs_y = 1.0 / (theta ** (torch.arange(0, dim, 4, device=device)[: (dim // 4)].float() / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    t_x = (t % end_x).float()
    t_y = torch.div(t, end_x, rounding_mode="floor").float()
    freqs_x = torch.outer(t_x, freqs_x)
    freqs_y = torch.outer(t_y, freqs_y)
    cis_x = torch.polar(torch.ones_like(freqs_x), freqs_x)
    cis_y = torch.polar(torch.ones_like(freqs_y), freqs_y)
    return torch.cat([cis_x, cis_y], dim=-1)


def apply_rotary_enc(xq, xk, freqs_cis, repeat_freqs_k=False):
    xq_ = torch.view_as_complex(xq.float().reshape(*xq.shape[:-1], -1, 2))
    xk_ = torch.view_as_complex(xk.float().reshape(*xk.shape[:-1], -1, 2))
    shape = [d if i >= xq_.ndim - 2 else 1 for i, d in enumerate(xq_.shape)]
    freqs_cis = freqs_cis.view(*shape)
    xq_out = torch.view_as_real(xq_ * freqs_cis).flatten(3)
    if repeat_freqs_k:
        r = xk_.shape[-2] // xq_.shape[-2]
        freqs_cis = freqs_cis.repeat(*([1] * (freqs_cis.ndim - 2)), r, 1)
    xk_out = torch.view_as_real(xk_ * freqs_cis).flatten(3)
    return xq_out.type_as(xq), xk_out.type_as(xk)


def rope_attention(cfg, sd, p, q, k, v, freqs_cis, repeat_k, num_k_exclude_rope=0):
    heads = cfg["memattn_heads"]
    q, k, v = _lin(sd, p + ".q_proj", q), _lin(sd, p + ".k_proj", k), _lin(sd, p + ".v_proj", v)
    sep = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
    q, k, v = sep(q), sep(k), sep(v)
    num_k_rope = k.size(-2) - num_k_exclude_rope
    k = k.clone()
    q, k[:, :, :num_k_rope] = apply_rotary_enc(q, k[:, :, :num_k_rope], freqs_cis, repeat_k)
    out = _sdpa(q, k, v).transpose(1, 2)
    return _lin(sd, p + ".out_proj", out.reshape(out.shape[0], out.shape[1], -1))


def memory_attention(cfg, sd, curr, curr_pos, memory, memory_pos, num_obj_ptr_tokens, hw):
    """curr, curr_pos (HW, B, C); memory, memory_pos (M, B, mem_dim), as
    upstream's sequence-first layout -> (HW, B, C)."""
    with precision():
        heads = cfg["memattn_heads"]
        dim = cfg["d_model"] // heads
        freqs = compute_axial_cis(dim, hw[1], hw[0], cfg["rope_theta"], curr.device)
        out = curr + 0.1 * curr_pos
        out, memory, memory_pos = out.transpose(0, 1), memory.transpose(0, 1), \
            memory_pos.transpose(0, 1)
        for i in range(cfg["memattn_layers"]):
            l = f"memory_attention.layers.{i}"
            t2 = _ln(sd, l + ".norm1", out, 1e-5)
            out = out + rope_attention(cfg, sd, l + ".self_attn", t2, t2, t2, freqs, False)
            t2 = _ln(sd, l + ".norm2", out, 1e-5)
            out = out + rope_attention(cfg, sd, l + ".cross_attn_image", t2, memory + memory_pos,
                                       memory, freqs, True, num_obj_ptr_tokens)
            t2 = _ln(sd, l + ".norm3", out, 1e-5)
            out = out + _lin(sd, l + ".linear2", F.relu(_lin(sd, l + ".linear1", t2)))
        return _ln(sd, "memory_attention.norm", out, 1e-5).transpose(0, 1)


def get_1d_sine_pe(pos_inds, dim, temperature=10000):
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos_embed = pos_inds.unsqueeze(-1) / dim_t
    return torch.cat([pos_embed.sin(), pos_embed.cos()], dim=-1)


def select_memories(cfg, frame_idx, num_frames, cond, non_cond):
    """Upstream's choice for a tracked frame (forward, stride 1, every
    prompted frame selected): [(t_pos, frame)] of the memories in their
    order and [(offset, frame)] of the pointers in theirs; cond and
    non_cond are the frame indices that have outputs."""
    num_maskmem = cfg["num_maskmem"]
    mems = [(0, t) for t in sorted(cond)]
    for t_pos in range(1, num_maskmem):
        t_rel = num_maskmem - t_pos
        if t_rel == 1:
            prev = frame_idx - t_rel
        else:
            prev = ((frame_idx - 2) // 1) * 1 - (t_rel - 2) * 1
        if prev in non_cond:
            mems.append((t_pos, prev))
    max_ptrs = min(num_frames, cfg["max_obj_ptrs_in_encoder"])
    ptrs = [(frame_idx - t, t) for t in sorted(cond) if t <= frame_idx]
    for t_diff in range(1, max_ptrs):
        t = frame_idx - t_diff
        if t < 0:
            break
        if t in non_cond:
            ptrs.append((t_diff, t))
    return mems, ptrs, max_ptrs


def prepare_memory(cfg, sd, frame_idx, num_frames, outputs, cond):
    """``_prepare_memory_conditioned_features``' bank for a tracked frame:
    outputs {frame: {"mem": (B, mem_dim, g, g), "mem_pos": (1, mem_dim, g,
    g), "ptr": (B, C)}} -> memory, memory_pos (M, B, mem_dim),
    num_obj_ptr_tokens, and the choice {"memory": [(frame, tpos index)],
    "pointers": [(frame, offset)]}."""
    num_maskmem, C, M = cfg["num_maskmem"], cfg["d_model"], cfg["mem_dim"]
    non_cond = set(outputs) - set(cond)
    mems, ptrs, max_ptrs = select_memories(cfg, frame_idx, num_frames, cond, non_cond)
    to_cat, to_cat_pos = [], []
    for t_pos, t in mems:
        out = outputs[t]
        to_cat.append(out["mem"].flatten(2).permute(2, 0, 1))
        enc = out["mem_pos"].flatten(2).permute(2, 0, 1)
        to_cat_pos.append(enc + sd["maskmem_tpos_enc"][num_maskmem - t_pos - 1])
    B = to_cat[0].shape[1]
    pos_list = torch.tensor([d for d, _ in ptrs], device=to_cat[0].device)
    obj_ptrs = torch.stack([outputs[t]["ptr"] for _, t in ptrs], dim=0)
    t_diff_max = max_ptrs - 1
    obj_pos = get_1d_sine_pe(pos_list / t_diff_max, dim=C)
    obj_pos = _lin(sd, "obj_ptr_tpos_proj", obj_pos).unsqueeze(1).expand(-1, B, M)
    obj_ptrs = obj_ptrs.reshape(-1, B, C // M, M).permute(0, 2, 1, 3).flatten(0, 1)
    obj_pos = obj_pos.repeat_interleave(C // M, dim=0)
    to_cat.append(obj_ptrs)
    to_cat_pos.append(obj_pos)
    choice = {"memory": sorted((t, num_maskmem - t_pos - 1) for t_pos, t in mems),
              "pointers": sorted((t, d) for d, t in ptrs)}
    return torch.cat(to_cat, dim=0), torch.cat(to_cat_pos, dim=0), obj_ptrs.shape[0], choice


def condition(cfg, sd, feat, pos, memory, memory_pos, num_ptr_tokens):
    """The memory-conditioned features (B, C, g, g) of feat (1 or B, C, g,
    g) with its PE pos (1, C, g, g), over a bank from prepare_memory."""
    B = memory.shape[1]
    _, C, h, w = feat.shape
    curr = feat.expand(B, -1, -1, -1).flatten(2).permute(2, 0, 1)
    curr_pos = pos.expand(B, -1, -1, -1).flatten(2).permute(2, 0, 1)
    out = memory_attention(cfg, sd, curr, curr_pos, memory, memory_pos, num_ptr_tokens, (h, w))
    return out.permute(1, 2, 0).reshape(B, C, h, w)


def propagate(cfg, sd, frames, masks):
    """Upstream's video predictor on a whole sequence, free-running: frames
    [(H, W, 3)], masks (B, 1, S, S) 0/1 on frame 0 -> per frame {"low",
    "ptr", "score", "mem", "choice"} (the memory bank's entries included).
    The reference of the tests' small propagation; the benchmark's check
    runs the pieces on the program's own inputs instead."""
    n, outs = len(frames), {}
    for f, frame in enumerate(frames):
        e = encode(cfg, sd, frame)
        B = masks.shape[0]
        if f == 0:
            o = use_mask_as_output(cfg, sd, e["feat"], e["s0"], e["s1"], masks)
            S = cfg["image_size"]
            high = F.interpolate(o["low"], size=(S, S), mode="bilinear", align_corners=False)
            choice = None
            from_pts = True
        else:
            mem, mem_pos, k, choice = prepare_memory(cfg, sd, f, n, outs, [0])
            cond = condition(cfg, sd, e["feat"], e["pos"], mem, mem_pos, k)
            o = sam_heads(cfg, sd, cond, e["s0"].expand(B, -1, -1, -1),
                          e["s1"].expand(B, -1, -1, -1))
            high, from_pts = o["high"], False
        mem, mem_pos = encode_memory(cfg, sd, e["feat"].expand(B, -1, -1, -1), high,
                                     o["score"], from_pts)
        outs[f] = {"low": o["low"], "ptr": o["ptr"], "score": o["score"], "mem": mem,
                   "mem_pos": mem_pos, "choice": choice}
    return outs
