"""PyTorch/CUDA port of gflow-tpu: the prior preparation that a fit reads
(``pipeline.prep_flow``, ``prep_moveseg``, ``prep_depth`` and
``prep_mask``, with the GMFlow, MASt3R and Segment Anything models of
``models/``), the 4D Gaussian fit of a video
(``pipeline.fit_video``) and the per-frame stages under it, the benchmark
that scores a fit (``eval.benchmark``), the viewer (``viz.viewer``) and
the TAP-Vid splitter (``pipeline.split_tapvid``), and the multi-GPU modes
(``parallel``: the tile-band fit, the scene sweep, sharded prep).

Mirrors the layout of ``gflow_tpu`` (``core/``, ``ops/``, ``opt/``,
``models/``, ``pipeline/``, ``eval/``, ``utils/``, ``viz/``, ``cli/``) so
each module's counterpart is easy to find. The compositor forward/backward
and the tile-list packer run as hand-written CUDA kernels (``csrc/``) on
CUDA tensors; CPU tensors take each kernel's plain PyTorch version. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and absent,
    rather than silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
