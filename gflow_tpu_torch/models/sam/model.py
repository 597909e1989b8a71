"""Segment Anything (``segment_anything/modeling/sam.py`` and
``build_sam.py``): the image encoder, the prompt encoder and the mask
decoder under the released keys (``image_encoder.*``,
``prompt_encoder.*``, ``mask_decoder.*``), so a released state dict such
as ``sam_vit_h_4b8939.pth`` loads with ``load_state_dict(strict=True)``.
``SamConfig()`` is ViT-H (``build_sam_vit_h``).

- ``encode(frame)``: an RGB frame (H, W, 3), 0-255, to the image
  embedding (1, C, 64, 64). The frame is resized so that its longer side
  is ``image_size`` (``input_size``: 854x480 -> 1024x576), normalized
  with SAM's pixel mean and std and zero-padded at the bottom and right
  to ``image_size`` square. Departure: upstream resizes the uint8 frame
  through PIL (``ResizeLongestSide``); here the resize is bilinear with
  antialias on the float frame, on the card.
- ``decode(embedding, points, labels)``: point prompts (B, N, 2) in
  pixels of the resized frame -> low-resolution mask logits (B, 3, 256,
  256) and predicted IoUs (B, 3), SAM's multimask outputs 1-3.
- ``postprocess_masks``: the logits to the frame's size (bilinear to the
  padded square, cropped to the resized frame, bilinear to (H, W)).

Every forward runs in float32 with TF32 off (``precision.fp32_math``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..precision import fp32_math
from .decoder import MaskDecoder, PromptEncoder
from .image_encoder import ImageEncoderViT

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SamConfig:
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: tuple = (7, 15, 23, 31)
    window_size: int = 14
    patch_size: int = 16
    image_size: int = 1024
    mlp_ratio: int = 4
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    # SAM 2's decoder heads (models/sam2): the object-score token and its
    # MLP, the high-resolution skips and the sigmoid IoU; off in SAM
    sam2_heads: bool = False


def input_size(h: int, w: int, long_side: int):
    """The frame's size with its longer side resized to long_side
    (``ResizeLongestSide.get_preprocess_shape``)."""
    s = long_side / max(h, w)
    return int(h * s + 0.5), int(w * s + 0.5)


def postprocess_masks(low_res, in_hw, frame_hw, image_size: int):
    """(B, M, 4h, 4w) logits -> (B, M, H, W) logits of the frame."""
    m = F.interpolate(low_res, (image_size, image_size), mode="bilinear", align_corners=False)
    m = m[..., :in_hw[0], :in_hw[1]]
    return F.interpolate(m, tuple(frame_hw), mode="bilinear", align_corners=False)


class SamModel(nn.Module):
    def __init__(self, config: SamConfig = SamConfig()):
        super().__init__()
        c = self.config = config
        grid = c.image_size // c.patch_size
        self.image_encoder = ImageEncoderViT(c)
        self.prompt_encoder = PromptEncoder(c.prompt_embed_dim, grid, c.image_size,
                                            c.mask_in_chans)
        self.mask_decoder = MaskDecoder(c)

    def encode(self, frame):
        with fp32_math():
            return self._encode(frame)

    def _encode(self, frame):
        S = self.config.image_size
        H, W = frame.shape[:2]
        h, w = input_size(H, W, S)
        x = frame.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, (h, w), mode="bilinear", align_corners=False, antialias=True)
        # per channel with scalars: no host-to-device copy (a CUDA graph records this)
        x = torch.cat([(x[:, i:i + 1] - m) / s
                       for i, (m, s) in enumerate(zip(PIXEL_MEAN, PIXEL_STD))], dim=1)
        return self.image_encoder(F.pad(x, (0, S - w, 0, S - h)))

    def decode(self, embedding, points, labels):
        with fp32_math():
            pe = self.prompt_encoder
            sparse = pe.sparse(points, labels)
            masks, iou, _, _ = self.mask_decoder(embedding, pe.image_pe(), sparse, pe.dense())
            return masks[:, 1:], iou[:, 1:]
