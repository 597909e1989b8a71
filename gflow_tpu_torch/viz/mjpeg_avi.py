"""Self-contained MJPEG-in-AVI writer (PIL encodes the JPEG frames).

Counterpart of ``gflow_tpu/viz/mjpeg_avi.py``. An AVI needs only a RIFF
container around its frames, plays everywhere, and keeps the pipeline's
video outputs where no mp4 encoder exists (the original writes mp4s
through imageio and ffmpeg, gflow/fit_video.py:399-406).
"""
from __future__ import annotations

import io
import struct

import numpy as np


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + (
        b"\x00" if len(payload) % 2 else b"")


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(path, frames, fps: int, quality: int = 90):
    """frames: iterable of (H, W, 3) uint8 arrays (all the same size)."""
    from PIL import Image

    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        return
    H, W = frames[0].shape[:2]
    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        jpegs.append(data + b"\x00" if len(data) % 2 else data)
    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I",
        int(1e6 / fps),  # microseconds per frame
        max_bytes * fps, # max bytes per sec
        0,               # padding granularity
        0x10,            # flags: AVIF_HASINDEX
        n,               # total frames
        0,               # initial frames
        1,               # streams
        max_bytes,       # suggested buffer size
        W, H, 0, 0, 0, 0,
    )
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIIII", 0, 0, 0, 0, 1, fps, 0, n, max_bytes,
                          0xFFFFFFFF, 0, 0)
            + struct.pack("<4H", 0, 0, W, H))
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG", W * H * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi = _list(b"movi", b"".join(_chunk(b"00dc", j) for j in jpegs))
    # idx1: offsets relative to the start of the 'movi' fourcc
    idx, off = [], 4
    for j in jpegs:
        idx.append(b"00dc" + struct.pack("<III", 0x10, off, len(j)))
        off += 8 + len(j) + len(j) % 2
    riff = b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(idx))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)
