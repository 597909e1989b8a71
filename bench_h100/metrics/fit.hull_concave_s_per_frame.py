"""Seconds a frame of the fit spends in the hull segmentation's concave
hulls: the trainer's ``hull/concave`` phase (inside ``host/hull_seg``: both
hulls and their mask rasters), over the window's frames. None where the
program records no such phase."""


def read(r):
    tel, frames = r.get("telemetry"), r.get("frames")
    if not tel or "hull/concave" not in tel or not frames:
        return None
    return tel["hull/concave"] / frames
