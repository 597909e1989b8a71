"""fp32 math for the prior models on the card.

cuDNN runs float32 convolutions in TF32 by default, and a caller may allow
TF32 matrix products (``torch.backends.cuda.matmul.allow_tf32``). The JAX
package computes these models in full float32, so every model forward of
the port runs inside ``fp32_math()``, which turns both off and restores the
caller's settings on exit.

Without TF32, cuDNN's algorithms for some float32 convolutions are slow on
an H100 (80GB HBM3, 700 W): a 3x3 convolution of (1, 256, 120, 216) to 192
channels takes 190 ms, where ATen's im2col + GEMM takes 0.76 ms
(scripts/torch_conv_algos.py). ``cudnn=False`` runs the block's
convolutions that way.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


# "fp32": the reference; "tf32": the control, TF32 matrix products and
# convolutions (set by reference.prep.pipeline.precision)
MODE = "fp32"


@contextmanager
def fp32_math(cudnn: bool = True):
    # the CUDA matmul flag round trip, not the global matmul precision's: a
    # caller's mix of TF32 settings (CUDA's allowed by allow_tf32, the CPU
    # backend's by set_float32_matmul_precision("high")) makes
    # torch.get_float32_matmul_precision() raise
    flags, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    tf32 = MODE == "tf32"
    matmul.allow_tf32 = tf32
    try:
        with flags.flags(enabled=flags.enabled and cudnn, benchmark=flags.benchmark,
                         deterministic=flags.deterministic, allow_tf32=tf32):
            yield
    finally:
        matmul.allow_tf32 = prev
