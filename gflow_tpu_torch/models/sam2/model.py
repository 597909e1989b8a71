"""SAM 2 (``sam2/modeling/sam2_base.py``, ``sam2_video_predictor.py``) as the
port runs it for video: the released modules under their keys, so that
``sam2.1_hiera_large.pt``'s ``"model"`` state dict loads with
``load_state_dict(strict=True)``, and a frame's step split into the parts
that the pipeline records as CUDA graphs. ``Sam2Config()`` is SAM 2.1
Hiera-L (``configs/sam2.1/sam2.1_hiera_l.yaml``, with the video
predictor's overrides: the decoder's dynamic multimask, the binarized
memory of a prompted frame).

- ``encode(frame)``: an RGB frame (H, W, 3), 0-255, resized to
  ``image_size`` square (SAM 2 does not keep the aspect), scaled to [0, 1]
  and normalized with ImageNet's mean and std, through Hiera and the FPN
  neck; the two finer levels through the decoder's ``conv_s0`` /
  ``conv_s1`` (``forward_image``) -> (feat_s0, feat_s1, feat).
- ``prompt(feat, feat_s0, feat_s1, masks)``: the prompted frame, its masks
  taken as the output (``_use_mask_as_output``): logits 20 m - 10,
  downsampled to the decoder's size; the object pointer from the decoder
  run on the mask as its dense prompt; object scores +-10 from whether a
  mask has a pixel. Also the memory encoder's input (the low-resolution
  logits back to ``image_size``, binarized as the video predictor encodes
  a prompted frame's memory).
- ``condition(feat, memory, tpos, ptrs, ptr_pos)``: the memory attention
  (``_prepare_memory_conditioned_features``) over the bank's memories
  (B, n, h*w, mem_dim), each with its spatial sine PE plus
  ``maskmem_tpos_enc[tpos[i]]``, and its object pointers (B, P, C), each
  split into C / mem_dim tokens with the signed temporal sine encoding of
  ``ptr_pos`` over (max pointers - 1) through ``obj_ptr_tpos_proj``.
- ``heads(cond, feat_s0, feat_s1)``: the decoder on a tracked frame, no
  points (the padding point twice) and no mask, multimask (the video
  predictor's tracking has no points, so ``_use_multimask`` holds): the
  best of masks 1-3 by predicted IoU, set to -1024 where the object score
  is not > 0, its token through ``obj_ptr_proj`` to the object pointer,
  which is ``no_obj_ptr`` where the object is absent.
- ``encode_memory(feat, high_res, score, binarize)``: the memory encoder on
  the mask at ``image_size`` (its logits through the sigmoid, or > 0 with
  `binarize`, times 20 minus 10), ``no_obj_embed_spatial`` added where the
  object score is not > 0 -> (B, h*w, mem_dim) token rows.

``MemoryBank`` holds the memories and pointers between frames on the
device and chooses, by upstream's rule, which of them a frame attends.
Every forward runs in float32 with TF32 off (``precision.fp32_math``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..precision import fp32_math
from ..sam.decoder import MaskDecoder, PromptEncoder
from .hiera import MLP, ImageEncoder, sine_pe
from .memory import MemoryAttention, MemoryEncoder

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NO_OBJ_SCORE = -1024.0


@dataclass(frozen=True)
class Sam2Config:
    # Hiera trunk
    embed_dim: int = 144
    num_heads: int = 2
    stages: tuple = (2, 6, 36, 4)
    global_att_blocks: tuple = (23, 33, 43)
    window_spec: tuple = (8, 4, 16, 8)
    window_pos_embed_bkg_spatial_size: tuple = (7, 7)
    q_pool: int = 3
    q_stride: int = 2
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    # FPN neck
    d_model: int = 256
    fpn_top_down_levels: tuple = (2, 3)
    scalp: int = 1
    image_size: int = 1024
    # memory attention
    memattn_layers: int = 4
    memattn_heads: int = 1
    memattn_ffn: int = 2048
    rope_theta: float = 10000.0
    # memory encoder and bank
    mem_dim: int = 64
    mask_ds_kernel: int = 3
    mask_ds_stride: int = 2
    mask_ds_padding: int = 1
    mask_ds_total_stride: int = 16
    fuser_layers: int = 2
    fuser_kernel: int = 7
    num_maskmem: int = 7
    max_obj_ptrs_in_encoder: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    # the SAM heads (models/sam/decoder.py, under these names)
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    sam2_heads: bool = True

    @property
    def grid(self) -> int:
        """The side of the coarsest kept level (the decoder's embedding):
        the patch embedding's stride 4 times the q-pooling's."""
        kept = len(self.stages) - self.scalp
        return self.image_size // (4 * self.q_stride ** min(self.q_pool, kept - 1))


def resize_frame(frame, size: int):
    """(H, W, 3) 0-255 -> (1, 3, size, size) normalized: bilinear with
    antialias on the card, /255, ImageNet's mean and std."""
    x = frame.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, (size, size), mode="bilinear", align_corners=False, antialias=True)
    # per channel with scalars: no host-to-device copy (a CUDA graph records this)
    return torch.cat([(x[:, i:i + 1] / 255.0 - m) / s
                      for i, (m, s) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], dim=1)


def sine_1d(pos, dim: int, temperature: float = 10000.0):
    """(P,) -> (P, dim): upstream's ``get_1d_sine_pe``."""
    half = dim // 2
    t = torch.arange(half, dtype=torch.float32, device=pos.device)
    t = temperature ** (2 * torch.div(t, 2, rounding_mode="floor") / half)
    p = pos[:, None] / t
    return torch.cat([p.sin(), p.cos()], dim=-1)


class Sam2Model(nn.Module):
    def __init__(self, config: Sam2Config = Sam2Config()):
        super().__init__()
        c = self.config = config
        C, M = c.d_model, c.mem_dim
        self.image_encoder = ImageEncoder(c)
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
        self.memory_attention = MemoryAttention(c)
        self.memory_encoder = MemoryEncoder(c)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(c.num_maskmem, 1, 1, M))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, M))
        self.obj_ptr_proj = MLP((C, C, C, C))
        self.obj_ptr_tpos_proj = nn.Linear(C, M)
        self.sam_prompt_encoder = PromptEncoder(C, c.grid, c.image_size, c.mask_in_chans)
        self.sam_mask_decoder = MaskDecoder(c)

    # --- the parts of a frame's step -------------------------------------

    def encode(self, frame):
        with fp32_math():
            x = resize_frame(frame, self.config.image_size)
            s0, s1, feat = self.image_encoder(x)
            dec = self.sam_mask_decoder
            # channels-first rows: the decoder's kernels read them so (the
            # trunk's outputs are channels-last views, and so are the convs')
            return (dec.conv_s0(s0).contiguous(), dec.conv_s1(s1).contiguous(),
                    feat.contiguous())

    def _sam_heads(self, image, feat_s0, feat_s1, dense):
        """The decoder with no points (the padding point twice): all masks,
        IoUs, mask tokens and object scores."""
        pe = self.sam_prompt_encoder
        B = dense.shape[0] if dense.dim() == 4 else image.shape[0]
        pts = image.new_zeros(B, 1, 2)
        labels = torch.full((B, 1), -1, dtype=torch.int64, device=image.device)
        return self.sam_mask_decoder(image, pe.image_pe(), pe.sparse(pts, labels), dense,
                                     (feat_s0, feat_s1))

    def _pointer(self, token, present):
        """The object pointer of a mask token (B, C), no_obj_ptr where the
        object is absent (present (B, 1) 0 or 1)."""
        ptr = present * self.obj_ptr_proj(token)
        return ptr + (1 - present) * self.no_obj_ptr

    def prompt(self, feat, feat_s0, feat_s1, masks):
        """masks (B, 1, S, S) 0/1 on the prompted frame -> (low-res logits
        (B, 1, S/4, S/4), object pointers (B, C), object scores (B, 1),
        the memory encoder's mask (B, 1, S, S))."""
        with fp32_math():
            S = self.config.image_size
            high = masks * 20.0 - 10.0
            low = F.interpolate(high, (S // 4, S // 4), mode="bilinear", align_corners=False,
                                antialias=True)
            dense = self.sam_prompt_encoder.dense(self.mask_downsample(masks))
            m, _, tokens, score = self._sam_heads(feat, feat_s0, feat_s1, dense)
            present = (score > 0).float()
            ptr = self._pointer(tokens[:, 0], present)
            shown = masks.flatten(1).gt(0).any(1, keepdim=True).float()
            ptr = shown * ptr + (1 - shown) * self.no_obj_ptr
            score = 20.0 * shown - 10.0
            mem_mask = F.interpolate(low, (S, S), mode="bilinear", align_corners=False)
            return low, ptr, score, mem_mask

    def condition(self, feat, memory, tpos, ptrs, ptr_pos, ptr_span: int):
        """feat (1, C, h, w); memory (B, n, h*w, M); tpos (n,) int64 indices
        into maskmem_tpos_enc; ptrs (B, P, C); ptr_pos (P,) float frame
        offsets; ptr_span the largest offset the encoding is normalized by
        -> the memory-conditioned features (B, C, h, w)."""
        with fp32_math():
            _, C, h, w = feat.shape
            B, n, N, M = memory.shape
            pos = sine_pe(M, h, w, feat.device).flatten(2).transpose(1, 2)[0]   # (N, M)
            mem_pos = pos[None] + self.maskmem_tpos_enc[tpos].reshape(n, 1, M)  # (n, N, M)
            P = ptrs.shape[1]
            split = C // M
            ptr_tok = ptrs.reshape(B, P, split, M).reshape(B, P * split, M)
            ptr_pe = self.obj_ptr_tpos_proj(sine_1d(ptr_pos / ptr_span, C))
            ptr_pe = ptr_pe.repeat_interleave(split, dim=0)                     # (P split, M)
            mem = torch.cat([memory.reshape(B, n * N, M), ptr_tok], dim=1)
            mem_pe = torch.cat([mem_pos.reshape(n * N, M), ptr_pe], dim=0)[None]
            curr = feat.flatten(2).transpose(1, 2).expand(B, -1, -1)
            curr_pos = sine_pe(C, h, w, feat.device).flatten(2).transpose(1, 2)
            out = self.memory_attention(curr, curr_pos, mem, mem_pe, P * split, (h, w))
            return out.transpose(1, 2).reshape(B, C, h, w).contiguous()

    def heads(self, cond, feat_s0, feat_s1):
        """cond (B, C, h, w) -> (all masks (B, 4, 4h, 4w), IoUs (B, 4),
        object scores (B, 1), the chosen low-res logits (B, 1, 4h, 4w),
        object pointers (B, C), the chosen logits at image_size (B, 1, S,
        S))."""
        with fp32_math():
            S = self.config.image_size
            masks, iou, tokens, score = self._sam_heads(cond, feat_s0, feat_s1,
                                                        self.sam_prompt_encoder.dense())
            present = score > 0
            best = torch.argmax(iou[:, 1:], dim=-1) + 1
            rows = torch.arange(masks.shape[0], device=masks.device)
            low = torch.where(present[:, :, None, None], masks[rows, best][:, None],
                              NO_OBJ_SCORE)
            high = F.interpolate(low, (S, S), mode="bilinear", align_corners=False)
            ptr = self._pointer(tokens[rows, best], present.float())
            return masks, iou, score, low, ptr, high

    def encode_memory(self, feat, high, score, binarize: bool):
        """feat (1, C, h, w), high (B, 1, S, S) logits, score (B, 1) ->
        (B, h*w, M)."""
        with fp32_math():
            c = self.config
            m = (high > 0).float() if binarize else torch.sigmoid(high)
            m = m * c.sigmoid_scale_for_mem_enc + c.sigmoid_bias_for_mem_enc
            mem = self.memory_encoder(feat, m)
            absent = (score <= 0).float()[:, :, None, None]
            mem = mem + absent * self.no_obj_embed_spatial[..., None, None]
            return mem.flatten(2).transpose(1, 2).contiguous()


def video_masks(low, hw):
    """Low-res logits (B, 1, h, w) -> (B, H, W) logits at the frame's size
    (bilinear, no crop: the frame was resized whole)."""
    return F.interpolate(low, tuple(hw), mode="bilinear", align_corners=False)[:, 0]


class MemoryBank:
    """Per sequence, on the device: the prompted frame's memory and the
    last ``num_maskmem - 1`` frames' in a ring, the prompted frame's object
    pointer and the last ``max_ptrs - 1`` frames' in another; each memory
    attended with the temporal encoding of its age, nothing concatenated
    between frames.

    Slot 0 holds the prompted frame (0); frame t >= 1 lies in slot 1 + (t -
    1) mod (capacity - 1). ``select(f)`` gives what frame f attends by
    upstream's rule (``_prepare_memory_conditioned_features``, forward, a
    stride of 1): the prompted frame's memory at temporal index
    num_maskmem - 1 and frame f - k's at k - 1 for k = 1 .. num_maskmem -
    1, and the pointers of frame 0 (offset f) and of frames f - d at d for
    d = 1 .. max_ptrs - 1, those frames that exist (> 0); max_ptrs is
    min(frames, ``max_obj_ptrs_in_encoder``). The slots a frame attends are
    the first of each ring (the rings fill in order), so the graph of a
    frame takes ring[:, :n] and its shape is set by the fill alone."""

    def __init__(self, config: Sam2Config, objects: int, grid: int, frames: int, device):
        c = config
        self.M = c.num_maskmem
        self.K = max(1, min(frames, c.max_obj_ptrs_in_encoder))
        self.mem = torch.zeros(objects, self.M, grid * grid, c.mem_dim, device=device)
        self.ptr = torch.zeros(objects, self.K, c.d_model, device=device)
        self.mem_frame = [-1] * self.M
        self.ptr_frame = [-1] * self.K

    def mem_slot(self, t: int) -> int:
        return 0 if t == 0 else 1 + (t - 1) % (self.M - 1)

    def ptr_slot(self, t: int) -> int:
        return 0 if t == 0 else 1 + (t - 1) % max(self.K - 1, 1)

    def store(self, t: int, memory, pointer) -> None:
        s = self.mem_slot(t)
        self.mem[:, s].copy_(memory)
        self.mem_frame[s] = t
        s = self.ptr_slot(t)
        self.ptr[:, s].copy_(pointer)
        self.ptr_frame[s] = t

    def select(self, f: int) -> dict:
        """What frame f >= 1 attends: n memory slots (the first n), their
        temporal indices, P pointer slots (the first P) and their frame
        offsets, and which frames they hold."""
        n = 1 + min(f - 1, self.M - 1)
        P = 1 + min(f - 1, self.K - 1)
        frames = self.mem_frame[:n]
        tpos = [self.M - 1 if t == 0 else f - t - 1 for t in frames]
        ptr_frames = self.ptr_frame[:P]
        return {"n": n, "P": P, "tpos": np.asarray(tpos, np.int64),
                "ptr_pos": np.asarray([f - t for t in ptr_frames], np.float32),
                "frames": list(frames), "ptr_frames": list(ptr_frames)}

    def memory(self, sel):
        return self.mem[:, :sel["n"]]

    def pointers(self, sel):
        return self.ptr[:, :sel["P"]]

    @property
    def ptr_span(self) -> int:
        """The offset the pointers' temporal encoding divides by."""
        return max(self.K - 1, 1)


def attended(sel: dict) -> dict:
    """A frame's choice as upstream's rule states it: {(frame, temporal
    index)} of its memories and {(frame, offset)} of its pointers."""
    return {"memory": sorted(zip(sel["frames"], sel["tpos"].tolist())),
            "pointers": sorted(zip(sel["ptr_frames"], sel["ptr_pos"].astype(int).tolist()))}
