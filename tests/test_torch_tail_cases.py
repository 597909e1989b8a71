"""Sorted-stream cases of the binning tail (``binning.bin_tail``, kernel
K4), shared by the CPU tests (tests/test_torch_binning.py, against a NumPy
construction of the definition) and the card tests
(tests/test_torch_cuda.py, the kernel against its plain version). It holds
no tests and imports neither jax nor anything that needs the card."""
import numpy as np
import torch

# sorted-stream cases of the binning tail (binning.bin_tail), T = 12 tiles
TAIL_CASES = ("empty_tiles", "all_sentinel", "empty_stream", "one_tile_over_K", "K_is_1",
              "random", "two_class")


def tail_stream(case, seed=0, T=12, K=8):
    """(key_s int32, order int64, idx_flat, depth_nbits, T, K) as NumPy, the
    stream sorted by NumPy. idx_flat is the group size G = 4 (Gaussian j
    emitted entries [4 j, 4 j + 4)), or for "two_class" an id array: 4
    entries for each of 16 Gaussians, then 8 for each of 5 large ones."""
    rng = np.random.default_rng(seed)
    idx_flat = 4
    if case == "empty_tiles":  # empty before the first entry, between entries, after the last
        tiles = rng.choice([2, 3, 5, 9, T], 60)
    elif case == "all_sentinel":
        tiles = np.full(40, T)
    elif case == "empty_stream":
        tiles = np.zeros(0, np.int64)
    elif case == "one_tile_over_K":
        tiles = np.full(48, 4)
    elif case == "K_is_1":
        tiles, K = rng.integers(0, T + 1, 64), 1
    elif case == "random":
        tiles = rng.integers(0, T + 1, 4 * (T + 1) * K)
    elif case == "two_class":
        lidx = rng.choice(16, 5, replace=False)
        idx_flat = np.r_[np.repeat(np.arange(16), 4), np.repeat(lidx, 8)].astype(np.int32)
        tiles = rng.integers(0, T + 1, len(idx_flat))
    else:
        raise ValueError(case)
    nbits = 31 - (T + 1).bit_length()
    keys = (tiles.astype(np.int64) << nbits) | rng.integers(0, 2 ** nbits, len(tiles))
    order = np.argsort(keys, kind="stable")
    return keys[order].astype(np.int32), order.astype(np.int64), idx_flat, nbits, T, K


def tail_tensors(stream, dev):
    return tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                 for a in stream)
