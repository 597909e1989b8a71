"""GMFlow / UniMatch optical flow (gmflow-scale2-regrefine6), in PyTorch:
the flow prior the reference's prep runs (scripts/flow_unimatch.sh).

Counterpart of ``gflow_tpu/models/unimatch/gmflow.py``. Submodules are
named after the released checkpoint's keys (autonomousvision/unimatch;
``convert.expected_torch_keys`` lists them), so a released state dict loads
with ``load_state_dict(strict=True)``:

  backbone.conv1 (7x7/2, parameter-free instance norms), layer{1,2,3}.{0,1}
  residual blocks (+ 1x1 ``downsample.0``), conv2 (1x1), trident_conv (one
  3x3 weight applied at strides 1 and 2: the 1/4 and 1/8 pyramid);
  transformer.layers.{i}.{self_attn,cross_attn_ffn}: LoFTR-style layers
  with swin window splits, shifted windows and their attention mask on odd
  layers, and a per-window sine position embedding; self_attn has no FFN;
  parameter-free global / local correlation softmax matching;
  feature_flow_attn (self-attention propagation, flow as value);
  refine_proj + refine (RAFT BasicUpdateBlock, run num_reg_refine times
  with shared weights) and convex upsampling.

Convolutions run NCHW; the transformer, correlations and propagation run
on channels-last (B, H, W, C) maps, as the JAX model. Attention and
correlations are plain matrix products; the forward runs in fp32
(``precision.fp32_math``), its convolutions as im2col + GEMM on the card.
GELU is exact erf, LayerNorm eps 1e-5.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dpt_head import bilinear_resize_ac
from .precision import fp32_math


@dataclass(frozen=True)
class GMFlowConfig:
    feature_channels: int = 128
    num_scales: int = 2                 # 1/8 + 1/4
    upsample_factor: int = 4            # at the finest scale
    num_transformer_layers: int = 6
    num_heads: int = 1
    attn_splits_list: tuple = (2, 8)
    corr_radius_list: tuple = (-1, 4)   # -1 = global
    prop_radius_list: tuple = (-1, 1)
    num_reg_refine: int = 6
    padding_factor: int = 32


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Encoder (RAFT-style residual CNN + trident multi-stride output)
# ---------------------------------------------------------------------------


def _inorm(x):
    return F.instance_norm(x, eps=1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, ch, 3, stride, 1)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, ch, 1, stride), nn.InstanceNorm2d(ch))
                           if stride != 1 or cin != ch else None)

    def forward(self, x):
        y = F.relu(_inorm(self.conv1(x)))
        y = F.relu(_inorm(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class TridentConv(nn.Module):
    """One 3x3 conv weight applied at several strides (upstream
    MultiScaleTridentConv)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch, ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(ch))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x, stride: int):
        return F.conv2d(x, self.weight, self.bias, stride=stride, padding=1)


class CNNEncoder(nn.Module):
    """Image (NCHW) -> [coarsest..finest] feature pyramid. For num_scales=2
    the base runs to 1/4 and the trident conv emits 1/8 and 1/4."""

    def __init__(self, out_ch: int = 128, num_scales: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64), ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96))
        s3 = 1 if num_scales > 1 else 2
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, s3), ResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(128, out_ch, 1)
        self.trident_conv = TridentConv(out_ch) if num_scales > 1 else None

    def forward(self, x):
        x = F.relu(_inorm(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        if self.trident_conv is None:
            return [x]
        return [self.trident_conv(x, 2), self.trident_conv(x, 1)]


# ---------------------------------------------------------------------------
# Position embedding (parameter-free sine, DETR-style)
# ---------------------------------------------------------------------------


def position_embedding_sine(H: int, W: int, dim: int, device=None) -> torch.Tensor:
    """(H, W, dim) normalized sine embedding, dim / 2 features per axis."""
    npf = dim // 2
    f32 = dict(dtype=torch.float32, device=device)
    eps, scale = 1e-6, 2 * math.pi
    ys = torch.arange(1, H + 1, **f32)[:, None] / (H + eps) * scale
    xs = torch.arange(1, W + 1, **f32)[None, :] / (W + eps) * scale
    dim_t = 10000.0 ** (2 * torch.div(torch.arange(npf, **f32), 2, rounding_mode="floor") / npf)
    py = (ys[..., None] / dim_t).expand(H, W, npf)
    px = (xs[..., None] / dim_t).expand(H, W, npf)

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], -1).reshape(H, W, -1)

    return torch.cat([interleave(py), interleave(px)], -1)


# ---------------------------------------------------------------------------
# Split (swin-style) LoFTR-form transformer
# ---------------------------------------------------------------------------


def _split_windows(x, s):
    """(B, H, W, C) -> (B*s*s, H/s * W/s, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, s, H // s, s, W // s, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * s * s, (H // s) * (W // s), C)


def _merge_windows(x, s, H, W):
    B = x.shape[0] // (s * s)
    x = x.reshape(B, s, s, H // s, W // s, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


# unbounded: a CUDA graph recorded on a mask reads it in place, so a mask
# must live as long as the graph (one per image size, split and device)
@functools.cache
def _shift_mask(H: int, W: int, s: int, device: str) -> torch.Tensor:
    """(s*s, L, L) additive mask for shifted windows (upstream
    generate_shift_window_attn_mask): after rolling by half a window,
    lanes from different pre-roll regions may not attend to each other."""
    wh, ww = H // s, W // s
    sh, sw = wh // 2, ww // 2
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, H - wh), slice(H - wh, H - sh), slice(H - sh, H)):
        for ws in (slice(0, W - ww), slice(W - ww, W - sw), slice(W - sw, W)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(s, wh, s, ww).transpose(0, 2, 1, 3).reshape(s * s, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


@functools.cache
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`values` as a tensor on `device`, made once: a CUDA graph's capture
    may not copy from the host, and a recorded graph reads the kept
    tensor. Made as a normal tensor, not an inference one, so that a
    forward with grad may save it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def shift_window_attn_mask(H: int, W: int, splits: int, device=None) -> torch.Tensor:
    return _shift_mask(H, W, splits, str(torch.device(device or "cpu")))


class TransformerLayer(nn.Module):
    """LoFTR-style message layer: attention message -> merge -> norm1
    [-> mlp(cat(source, message)) -> norm2 unless no_ffn] -> residual add.
    with_shift (odd layers when splits > 1) rolls q/k/v by half a window,
    masks cross-boundary attention and rolls the message back."""

    def __init__(self, dim: int, no_ffn: bool = False):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.merge = nn.Linear(dim, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim)
        self.no_ffn = no_ffn
        if not no_ffn:
            self.mlp = nn.Sequential(nn.Linear(2 * dim, 8 * dim, bias=False), nn.GELU(),
                                     nn.Linear(8 * dim, dim, bias=False))
            self.norm2 = nn.LayerNorm(dim)

    def forward(self, source, target, splits: int, with_shift: bool = False):
        B, H, W, C = source.shape
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        shifted = with_shift and splits > 1
        if shifted:
            sh, sw = (H // splits) // 2, (W // splits) // 2
            q, k, v = (torch.roll(t, (-sh, -sw), dims=(1, 2)) for t in (q, k, v))
        qs, ks, vs = (_split_windows(t, splits) for t in (q, k, v))
        attn = torch.matmul(qs, ks.transpose(1, 2)) / math.sqrt(C)
        if shifted:
            L = qs.shape[1]
            mask = shift_window_attn_mask(H, W, splits, source.device)
            attn = (attn.view(B, splits * splits, L, L) + mask).view(B * splits * splits, L, L)
        msg = _merge_windows(torch.matmul(torch.softmax(attn, -1), vs), splits, H, W)
        if shifted:
            msg = torch.roll(msg, (sh, sw), dims=(1, 2))
        msg = self.norm1(self.merge(msg))
        if self.no_ffn:
            return source + msg
        return source + self.norm2(self.mlp(torch.cat([source, msg], -1)))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = TransformerLayer(dim, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(dim)

    def forward(self, source, target, splits, with_shift=False):
        source = self.self_attn(source, source, splits, with_shift)
        return self.cross_attn_ffn(source, target, splits, with_shift)


class FeatureTransformer(nn.Module):
    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(dim) for _ in range(num_layers))

    def forward(self, feat0, feat1, splits: int):
        # both directions as one batch (source, target) = (f0|f1, f1|f0)
        B = feat0.shape[0]
        src = torch.cat([feat0, feat1])
        for i, layer in enumerate(self.layers):
            tgt = torch.cat([src[B:], src[:B]])
            src = layer(src, tgt, splits, splits > 1 and i % 2 == 1)  # swin: shift odd layers
        return src[:B], src[B:]


# ---------------------------------------------------------------------------
# Correlation matching (parameter-free)
# ---------------------------------------------------------------------------


def _coords_grid(B, H, W, device=None):
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], -1)[None].expand(B, H, W, 2)


def global_correlation_softmax(feat0, feat1):
    """Global matching: flow = softmax-weighted displacement."""
    B, H, W, C = feat0.shape
    corr = torch.matmul(feat0.reshape(B, H * W, C), feat1.reshape(B, H * W, C).transpose(1, 2))
    prob = torch.softmax(corr / math.sqrt(C), -1)
    grid = _coords_grid(B, H, W, feat0.device).reshape(B, H * W, 2)
    return (torch.matmul(prob, grid) - grid).reshape(B, H, W, 2)


def _window_taps(x, r):
    """Zero-padded shifted views of (B, H, W, C), (dy, dx) row-major over
    [-r, r]^2, with each tap's (dx, dy) offset."""
    H, W = x.shape[1:3]
    pad = F.pad(x, (0, 0, r, r, r, r))
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yield pad[:, r + dy:r + dy + H, r + dx:r + dx + W], (dx, dy)


def local_correlation_softmax(feat0, feat1, radius: int):
    """Matching within +-radius. Offsets that land outside the image are
    excluded from the softmax (upstream masks them to -1e9)."""
    B, H, W, C = feat0.shape
    dev = feat0.device
    xs, ys = torch.arange(W, device=dev)[None, :], torch.arange(H, device=dev)[:, None]
    corr, valid, offs = [], [], []
    for f1, (dx, dy) in _window_taps(feat1, radius):
        corr.append(torch.sum(feat0 * f1, -1))
        valid.append((xs + dx >= 0) & (xs + dx <= W - 1) & (ys + dy >= 0) & (ys + dy <= H - 1))
        offs.append((dx, dy))
    corr = torch.stack(corr, -1) / math.sqrt(C)
    corr = torch.where(torch.stack(valid, -1)[None], corr, -1e9)
    off = _constant(tuple(offs), torch.float32, dev)
    return torch.matmul(torch.softmax(corr, -1), off)


class SelfAttnPropagation(nn.Module):
    """Flow propagation by feature self-attention with learned q/k
    projections, flow as value; radius -1 = global, else a local window."""

    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)

    def forward(self, feat0, flow, radius: int):
        B, H, W, C = feat0.shape
        q, k = self.q_proj(feat0), self.k_proj(feat0)
        if radius < 0:
            attn = torch.matmul(q.reshape(B, H * W, C), k.reshape(B, H * W, C).transpose(1, 2))
            prob = torch.softmax(attn / math.sqrt(C), -1)
            return torch.matmul(prob, flow.reshape(B, H * W, 2)).reshape(B, H, W, 2)
        kk = torch.stack([t for t, _ in _window_taps(k, radius)], 3)
        vk = torch.stack([t for t, _ in _window_taps(flow, radius)], 3)
        attn = torch.sum(q[:, :, :, None] * kk, -1) / math.sqrt(C)
        return torch.sum(torch.softmax(attn, -1)[..., None] * vk, 3)


# ---------------------------------------------------------------------------
# Refinement (RAFT BasicUpdateBlock) + upsampling
# ---------------------------------------------------------------------------


def _gather(img, yi, xi):
    """img (B, H, W, C) at integer (yi, xi) of shape (B, ...) -> (B, ..., C),
    whole C-vectors selected by one flat index each."""
    B, H, W, C = img.shape
    first = torch.arange(B, device=img.device).view(B, *[1] * (yi.dim() - 1)) * (H * W)
    idx = (first + yi * W + xi).reshape(-1)
    return img.reshape(B * H * W, C).index_select(0, idx).reshape(*yi.shape, C)


def _bilinear_sample(img, coords):
    """img (B, H, W, C), coords (B, h, w, 2) absolute xy -> (B, h, w, C).
    Out-of-bounds corners contribute zero (grid_sample padding 'zeros',
    align_corners=True)."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def corner(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).to(torch.int64)
        yc = yi.clamp(0, H - 1).to(torch.int64)
        return _gather(img, yc, xc) * inb[..., None].to(img.dtype)

    return (corner(x0, y0) * (1 - wx) * (1 - wy) + corner(x0 + 1, y0) * wx * (1 - wy)
            + corner(x0, y0 + 1) * (1 - wx) * wy + corner(x0 + 1, y0 + 1) * wx * wy)


def local_correlation_with_flow(feat0, feat1, flow, radius: int):
    """(B, H, W, (2r+1)^2) correlation of feat0[x] with feat1 bilinearly
    sampled at x + flow(x) + offset, for each integer window offset
    ((dy, dx) row-major), zero outside the image (upstream
    local_correlation_with_flow: grid_sample per tap).

    As the JAX package computes it: the taps share the fractional part of
    x + flow(x), and bilinear interpolation is linear, so the dot products
    with feat0 are taken once on the (2r+2)^2 integer neighbourhood of
    floor(x + flow) (zero-padded), and each tap is the 4-term bilinear
    combination of four of them."""
    B, H, W, C = feat0.shape
    r = radius
    P, k = 2 * r + 2, 2 * r + 1
    base = _coords_grid(B, H, W, feat0.device) + flow
    fl = torch.floor(base)
    fr = base - fl
    # zero-pad by P: a tap outside the image reads an exact zero; the start
    # is clipped (as the JAX gather's) only where the whole window is out
    padded = F.pad(feat1, (0, 0, P, P, P, P))
    sy = (fl[..., 1] - r + P).clamp(0, H + P).to(torch.int64)
    sx = (fl[..., 0] - r + P).clamp(0, W + P).to(torch.int64)
    cols = sx[..., None] + torch.arange(P, device=feat0.device)    # (B, H, W, P)
    dots = []
    for dy in range(P):  # one row of the neighbourhood at a time
        patch = _gather(padded, (sy + dy)[..., None].expand_as(cols), cols)  # (B, H, W, P, C)
        dots.append(torch.sum(patch * feat0[:, :, :, None], -1))
    dots = torch.stack(dots, 3) / math.sqrt(C)        # (B, H, W, P, P)
    wx, wy = fr[..., 0, None, None], fr[..., 1, None, None]
    corr = ((1 - wx) * (1 - wy) * dots[..., :k, :k] + wx * (1 - wy) * dots[..., :k, 1:]
            + (1 - wx) * wy * dots[..., 1:, :k] + wx * wy * dots[..., 1:, 1:])
    return corr.reshape(B, H, W, k * k)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(256, 126, 3, 1, 1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], 1))), flow], 1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, inp: int = 256):
        super().__init__()
        for name, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}", nn.Conv2d(hidden + inp, hidden, ks, padding=pad))

    def forward(self, h, x):
        for n in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{n}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{n}")(hx))
            q = torch.tanh(getattr(self, f"convq{n}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 256, 3, 1, 1)
        self.conv2 = nn.Conv2d(256, 2, 3, 1, 1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, mask_ch: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, 1, 1), nn.ReLU(),
                                  nn.Conv2d(256, mask_ch, 1))

    def forward(self, net, inp, corr, flow):
        """NCHW in and out: (net, upsampling mask, flow update)."""
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, self.mask(net), self.flow_head(net)


def upsample_flow_with_mask(flow, mask, factor: int):
    """RAFT convex upsampling of flow (B, 2, H, W) with mask
    (B, 9*f*f, H, W), softmaxed over the 3x3 neighbourhood of the (x f)
    coarse flow; the neighbourhood is the mask's major channel axis."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.view(B, 1, 9, factor, factor, H, W), dim=2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, factor * H, factor * W)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class GMFlow(nn.Module):
    def __init__(self, config: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        c = self.config = config
        d = c.feature_channels
        self.backbone = CNNEncoder(d, c.num_scales)
        self.transformer = FeatureTransformer(d, c.num_transformer_layers)
        self.feature_flow_attn = SelfAttnPropagation(d)
        mask_ch = c.upsample_factor ** 2 * 9
        if c.num_reg_refine > 0:
            self.refine_proj = nn.Conv2d(d, 256, 1)
            self.refine = BasicUpdateBlock(81, mask_ch)
        else:
            self.upsampler = nn.Sequential(nn.Conv2d(2 + d, 256, 3, 1, 1), nn.ReLU(),
                                           nn.Conv2d(256, mask_ch, 1))

    def forward(self, img0, img1):
        """img0, img1: (B, H, W, 3) in [0, 1], H and W multiples of
        padding_factor. Returns the full-resolution flow (B, H, W, 2)."""
        # cuDNN's fp32 algorithms for the refinement's 3x3 convolutions
        # took a directed pair at 864x480 from 0.12 to 1.71 s on an H100
        # (scripts/torch_profile_prep.py): convolve without it
        with fp32_math(cudnn=False):
            return self._forward(img0, img1)

    def _forward(self, img0, img1):
        cfg = self.config
        B = img0.shape[0]
        dev = img0.device
        # upstream normalize_img: ImageNet mean/std, not 2x-1
        mean, std = _constant(_MEAN, img0.dtype, dev), _constant(_STD, img0.dtype, dev)
        feats = self.backbone(_nchw((torch.cat([img0, img1]) - mean) / std))
        feats0 = [_nhwc(f[:B]) for f in feats]
        feats1 = [_nhwc(f[B:]) for f in feats]

        flow = None
        for s in range(cfg.num_scales):
            f0, f1 = feats0[s], feats1[s]
            h, w = f0.shape[1:3]
            if flow is not None:
                # upstream upsamples the inter-scale flow with
                # F.interpolate(align_corners=True)
                flow = _nhwc(bilinear_resize_ac(_nchw(flow), h, w)) * 2.0
                f1 = _bilinear_sample(f1, _coords_grid(B, h, w, dev) + flow)
            # with attn_splits > 1 the sine embedding is computed per window
            sp = cfg.attn_splits_list[s]
            pos = position_embedding_sine(h // sp, w // sp, cfg.feature_channels, dev)
            pos = pos.repeat(sp, sp, 1)[None]
            f0t, f1t = self.transformer(f0 + pos, f1 + pos, sp)

            radius = cfg.corr_radius_list[s]
            delta = (global_correlation_softmax(f0t, f1t) if radius < 0
                     else local_correlation_softmax(f0t, f1t, radius))
            flow = delta if flow is None else flow + delta
            flow = self.feature_flow_attn(f0t, flow.detach(), cfg.prop_radius_list[s])

        f = cfg.upsample_factor
        if cfg.num_reg_refine > 0:
            net, inp = torch.chunk(self.refine_proj(_nchw(f0t)), 2, dim=1)
            net, inp = torch.tanh(net), F.relu(inp)
            # upstream correlates the backbone features of the finest scale
            # (before warping, position embedding and transformer)
            f0_ori, f1_ori = feats0[-1], feats1[-1]
            for _ in range(cfg.num_reg_refine):
                flow = flow.detach()
                corr = local_correlation_with_flow(f0_ori, f1_ori, flow, radius=4)
                net, up_mask, dflow = self.refine(net, inp, _nchw(corr), _nchw(flow))
                flow = flow + _nhwc(dflow)
        else:
            up_mask = self.upsampler(_nchw(torch.cat([flow, feats0[-1]], -1)))
        return _nhwc(upsample_flow_with_mask(_nchw(flow), up_mask, f))


def consistency_terms(flow_fwd, flow_bwd, alpha=0.01, beta=0.5):
    """The quantities forward_backward_consistency thresholds, per
    direction: ((diff_fwd, bound_fwd), (diff_bwd, bound_bwd)), each
    (B, H, W); a pixel is occluded where diff > bound."""
    B, H, W, _ = flow_fwd.shape
    grid = _coords_grid(B, H, W, flow_fwd.device)
    bwd_at_fwd = _bilinear_sample(flow_bwd, grid + flow_fwd)
    fwd_at_bwd = _bilinear_sample(flow_fwd, grid + flow_bwd)

    def terms(fa, fb_warp):
        diff = torch.sum((fa + fb_warp) ** 2, -1)
        bound = alpha * (torch.sum(fa ** 2, -1) + torch.sum(fb_warp ** 2, -1)) + beta
        return diff, bound

    return terms(flow_fwd, bwd_at_fwd), terms(flow_bwd, fwd_at_bwd)


def forward_backward_consistency(flow_fwd, flow_bwd, alpha=0.01, beta=0.5):
    """Occlusion maps from forward/backward flow consistency (the check the
    reference enables with --fwd_bwd_check). flow_fwd, flow_bwd:
    (B, H, W, 2). Returns (occ_fwd, occ_bwd), float 0/1 maps."""
    return tuple((diff > bound).to(torch.float32)
                 for diff, bound in consistency_terms(flow_fwd, flow_bwd, alpha, beta))
