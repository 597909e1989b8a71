"""The tile compositor's work per (pixel, live slot), counted from the
function (``gflow_tpu_torch/csrc/composite.cu``'s arithmetic): alpha 17
(dx dy 2, power 9, min + exp + mul + clamp 4, masks 2); K1 adds the blend
weight 1, the features 2F and the transmittance 2; K2 adds the coverage's
mul + max 2. The backward evaluates alpha 17, the features 2F, the weight
1 and the transmittance 2 once, plus the suffix sum 2, dalpha 5, dpower 1,
the conic moments 5, dfeat F and one add per reduced value 6 + F."""
from __future__ import annotations

TILE_PIXELS = 256


def ops_k1(F: int) -> int:
    return 20 + 2 * F


def ops_k2(F: int) -> int:
    return 22 + 2 * F


def ops_k3(F: int) -> int:
    return 39 + 4 * F


def attr_columns(F: int, with_cov: bool = False) -> int:
    """uv 2, conic 3, opacity 1, the features, the coverage flag."""
    return 6 + F + int(with_cov)


def forward(pairs: int, n_gauss: int, F: int, T: int, K: int, pixels: int,
            with_cov: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one forward: every live (pixel, slot) pair;
    the Gaussians' attributes and the tile lists read, the image (and the
    coverage) written."""
    ops = pairs * (ops_k2(F) if with_cov else ops_k1(F))
    nbytes = 4 * (n_gauss * attr_columns(F, with_cov) + T * K + T + pixels * (F + int(with_cov)))
    return float(ops), float(nbytes)


def backward(pairs: int, n_gauss: int, F: int, T: int, K: int, pixels: int):
    """(operations, bytes) of one backward: the attributes, the lists and
    the image's gradient read, the attributes' gradient written."""
    ops = pairs * ops_k3(F)
    cols = attr_columns(F)
    nbytes = 4 * (n_gauss * cols + T * K + T + pixels * F + n_gauss * cols)
    return float(ops), float(nbytes)
