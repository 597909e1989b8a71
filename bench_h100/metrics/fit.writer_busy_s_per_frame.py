"""Seconds a frame of the fit spends in jobs of the background writer,
summed over its lanes: the trainer's ``writer/busy`` counter (the
writer's busy seconds between the ends of the stages that saved
images), over the window's frames. None where the program records no
such counter."""


def read(r):
    tel, frames = r.get("telemetry"), r.get("frames")
    if not tel or "writer/busy" not in tel or not frames:
        return None
    return tel["writer/busy"] / frames
