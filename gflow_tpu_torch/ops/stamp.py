"""Timestamps of the pieces of a stage's iteration (``csrc/stamp.cu``).

A stage's iteration runs as one CUDA graph replay, inside which no host
range is replayed, so its pieces are timed by stamps written where they
run: ``stamp(it, table, col)`` writes the time into row ``it[0]``, column
`col` of the (rows, ``COLS``) int64 `table`. On a CUDA tensor the
``stamp`` kernel, launched on the current stream (inside a capture it is
recorded and runs at every replay; eagerly a host clock would time only
the enqueue), writes the card's global timer in ns; on the CPU the plain
version writes the host's ``time.perf_counter_ns()``. Only differences of
one table's stamps are read (``pieces``).

An iteration's columns: its start, after projection, binning and
compositing, after the losses (the forward's end), after the backward,
after the gated Adam step and the loss trace's write (its end). The mask
prior (``pipeline/prep_mask.py``) stamps between graph replays the same
way, a row for the encode and one for each decode batch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import _build

PIECES = ("render", "loss", "backward", "update")  # between consecutive columns
COLS = len(PIECES) + 1


def stamp(it: torch.Tensor, table: torch.Tensor, col: int) -> None:
    """The time into table[it[0], col]; `it` a (1,) int64 tensor on the
    table's device. A row outside the table is not written."""
    rows, cols = table.shape
    if table.is_cuda:
        _build.launch("stamp", it, table, rows, cols, col)
        return
    row = int(it[0])
    if 0 <= row < rows:
        table[row, col] = time.perf_counter_ns()


def pieces(table) -> dict:
    """Seconds in all of each of ``PIECES`` over a stage's stamp table
    (iterations, ``COLS``) and of "between": from each iteration's last
    stamp to the next one's first (the rebinning, densify and snapshot
    pieces run there, and any gap of the host's launches)."""
    t = np.asarray(table, np.int64)
    if not len(t):
        return {}
    out = dict(zip(PIECES, (np.diff(t, axis=1).sum(0) * 1e-9).tolist()))
    out["between"] = float((t[1:, 0] - t[:-1, -1]).sum()) * 1e-9
    return out
