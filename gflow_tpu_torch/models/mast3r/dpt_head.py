"""DPT pixelwise head and MASt3R catMLP local-feature head, in PyTorch.

Counterpart of ``gflow_tpu/models/mast3r/dpt_head.py``: the
``catmlp+dpt`` heads of the reference's checkpoint
(``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth``). Four hooked
token sets become maps at strides 4/8/16/32 (1x1 conv, then a 4x4-s4 or
2x2-s2 transposed conv, identity, or a 3x3-s2 conv), are projected to 256
channels (``layerN_rn``), refined top-down (residual conv units and x2
bilinear upsampling, align_corners=True), and a head (3x3 conv, x2, 3x3
conv, ReLU, 1x1 conv) gives pts3d + confidence; an MLP over
cat(encoder, decoder) tokens, pixel-shuffled, gives the descriptors.

Modules run NCHW and are named after the released keys
(``dpt.act_postprocess.{j}.{k}``, ``dpt.scratch.layerN_rn``,
``dpt.scratch.refinenetN``, ``dpt.head.{0,2,4}``,
``head_local_features.fc{1,2}``). ``refinenet4`` has no ``resConfUnit1``:
its forward never runs it, and the loader drops the released dead weights.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def bilinear_resize_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) with align_corners=True
    (src = dst * (in - 1) / (out - 1); a single input or output row reads
    row 0), as the JAX package's channels-last version."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """DPT FeatureFusionBlock_custom (deconv=False, bn=False, expand=False,
    align_corners=True); `with_skip=False` for the top block."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None):
        out = x if res is None else x + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        out = bilinear_resize_ac(out, out.shape[2] * 2, out.shape[3] * 2)
        return self.out_conv(out)


class _Scratch(nn.Module):
    def __init__(self, layer_dims, f):
        super().__init__()
        for n, d in enumerate(layer_dims, 1):
            setattr(self, f"layer{n}_rn", nn.Conv2d(d, f, 3, 1, 1, bias=False))
            setattr(self, f"refinenet{n}", FusionBlock(f, with_skip=n < 4))


class DptCore(nn.Module):
    """CroCo DPTOutputAdapter: four hooked token layers -> (B, C, H, W) map
    at 16x the token grid. `dim_tokens` are the hooked layers' widths."""

    def __init__(self, dim_tokens: Sequence[int], num_channels: int = 4,
                 feature_dim: int = 256, last_dim: int = 128,
                 layer_dims: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        ld, f = layer_dims, feature_dim
        # kernel == stride transposed convs: the JAX package's ConvTransposeExpand
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dim_tokens[0], ld[0], 1), nn.ConvTranspose2d(ld[0], ld[0], 4, 4)),
            nn.Sequential(nn.Conv2d(dim_tokens[1], ld[1], 1), nn.ConvTranspose2d(ld[1], ld[1], 2, 2)),
            nn.Sequential(nn.Conv2d(dim_tokens[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(dim_tokens[3], ld[3], 1), nn.Conv2d(ld[3], ld[3], 3, 2, 1)),
        ])
        self.scratch = _Scratch(ld, f)
        self.head = nn.Sequential(
            nn.Conv2d(f, last_dim, 3, 1, 1), nn.Identity(),  # x2 upsampling between
            nn.Conv2d(last_dim, last_dim, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(last_dim, num_channels, 1))

    def forward(self, layers, hw):
        h, w = hw
        maps = [tok.transpose(1, 2).reshape(tok.shape[0], tok.shape[2], h, w) for tok in layers]
        l0, l1, l2, l3 = (post(m) for post, m in zip(self.act_postprocess, maps))
        s = self.scratch
        r0, r1, r2, r3 = s.layer1_rn(l0), s.layer2_rn(l1), s.layer3_rn(l2), s.layer4_rn(l3)
        crop = lambda p, r: p[:, :, :r.shape[2], :r.shape[3]]  # odd token grids
        p4 = crop(s.refinenet4(r3), r2)
        p3 = crop(s.refinenet3(p4, r2), r1)
        p2 = crop(s.refinenet2(p3, r1), r0)
        p1 = s.refinenet1(p2, r0)
        out = self.head[0](p1)
        out = bilinear_resize_ac(out, out.shape[2] * 2, out.shape[3] * 2)
        return self.head[4](F.relu(self.head[2](out)))


def pixel_shuffle_tokens(y: torch.Tensor, h: int, w: int, C: int, p: int) -> torch.Tensor:
    """(B, h*w, C*p*p) tokens, feature index c*p*p + dy*p + dx (torch
    F.pixel_shuffle ordering) -> (B, C, h*p, w*p)."""
    B = y.shape[0]
    return F.pixel_shuffle(y.transpose(1, 2).reshape(B, C * p * p, h, w), p)


def reg_dense_pts3d(xyz: torch.Tensor) -> torch.Tensor:
    """dust3r 'exp' depth mode, no bounds, on (B, 3, H, W): unit direction
    times expm1(norm), the norm clamped at 60."""
    d = torch.sqrt(torch.sum(xyz * xyz, dim=1, keepdim=True))
    return xyz / d.clamp_min(1e-8) * torch.expm1(d.clamp_max(60.0))


class LocalFeaturesMlp(nn.Module):
    """timm-style Mlp (fc1 / exact GELU / fc2), hidden 4x the input width."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 4 * in_features)
        self.fc2 = nn.Linear(4 * in_features, out_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CatMlpDptHead(nn.Module):
    """MASt3R Cat_MLP_LocalFeatures_DPT_Pts3d: DPT for pts3d + conf, an MLP
    over cat(encoder tokens, final decoder tokens) for descriptors and
    their confidence. Outputs are channels-last (B, H, W, C)."""

    def __init__(self, dim_tokens: Sequence[int], enc_dim: int, dec_dim: int,
                 patch_size: int = 16, local_feat_dim: int = 24):
        super().__init__()
        self.patch_size, self.local_feat_dim = patch_size, local_feat_dim
        self.dpt = DptCore(dim_tokens)
        self.head_local_features = LocalFeaturesMlp(
            enc_dim + dec_dim, (local_feat_dim + 1) * patch_size ** 2)

    def forward(self, hooked, enc_out, dec_out, hw, img_hw):
        H, W = img_hw
        h, w = hw
        p, d = self.patch_size, self.local_feat_dim
        fmap = self.dpt(hooked, hw)[:, :, :H, :W]
        pts = reg_dense_pts3d(fmap[:, :3])
        conf = 1.0 + torch.exp(fmap[:, 3:4].clamp(-20.0, 20.0))
        x = self.head_local_features(torch.cat([enc_out, dec_out], dim=-1))
        lf = pixel_shuffle_tokens(x, h, w, d + 1, p)[:, :, :H, :W]
        desc = lf[:, :d]
        desc = desc / torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True)).clamp_min(1e-8)
        desc_conf = torch.exp(lf[:, d:].clamp(-20.0, 20.0))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {"pts3d": nhwc(pts), "conf": nhwc(conf), "desc": nhwc(desc),
                "desc_conf": nhwc(desc_conf)}
