"""Seconds a frame of the fit spends in the hull segmentation's erosion:
the trainer's ``hull/erode`` phase (inside ``host/hull_seg``: SciPy's 20x20
binary erosion), over the window's frames. None where the program records
no such phase."""


def read(r):
    tel, frames = r.get("telemetry"), r.get("frames")
    if not tel or "hull/erode" not in tel or not frames:
        return None
    return tel["hull/erode"] / frames
