"""Seconds a frame of the fit spends in jobs of the background writer's
thread while the main thread is in the hull segmentation: the trainer's
``writer/busy_in_hull`` counter (the writer's busy seconds over
``host/hull_seg``), over the window's frames. None where the program
records no such counter."""


def read(r):
    tel, frames = r.get("telemetry"), r.get("frames")
    if not tel or "writer/busy_in_hull" not in tel or not frames:
        return None
    return tel["writer/busy_in_hull"] / frames
