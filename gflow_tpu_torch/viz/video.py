"""Video writing (the original's gflow/fit_video.py:399-406).

Counterpart of ``gflow_tpu/viz/video.py``: an mp4 through imageio where
imageio imports and has an encoder, else an MJPEG .avi of the same
basename (PIL encodes its frames).
"""
from __future__ import annotations

import functools
import os
import tempfile

import numpy as np


@functools.lru_cache(maxsize=None)
def _mp4_available() -> bool:
    fd, probe = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        import imageio.v2 as imageio

        imageio.get_writer(probe, fps=5).close()
    except Exception:  # no imageio, or assorted types when it has no encoder
        return False
    finally:
        os.unlink(probe)
    return True


def save_video(path, frames, fps: int):
    """Write frames to `path` (see the module docstring for the format).
    Returns the path actually written, or None for empty input."""
    if not frames:
        return None
    frames = [np.asarray(f).astype(np.uint8) for f in frames]
    path = str(path)
    if path.endswith(".mp4") and not _mp4_available():
        path = path[:-4] + ".avi"
    if path.endswith(".avi"):
        from .mjpeg_avi import write_mjpeg_avi

        write_mjpeg_avi(path, frames, fps)
        return path
    import imageio.v2 as imageio

    with imageio.get_writer(path, fps=fps) as w:
        for f in frames:
            w.append_data(f)
    return path
