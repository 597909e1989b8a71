"""Seconds a frame of the prior preparation spends in prep_flow (GMFlow
both ways, the fwd-bwd check, the files written): the driver's span over
the frames of the window's sequences."""


def read(r):
    t, frames = r.get("spans", {}).get("prep_flow"), r.get("frames")
    return t / frames if t and frames else None
