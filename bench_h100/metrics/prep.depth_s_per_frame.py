"""Seconds a frame of the prior preparation spends in prep_depth (MASt3R
over the logwin pairs, the global alignment, depth and camera files): the
driver's span over the frames of the window's sequences."""


def read(r):
    t, frames = r.get("spans", {}).get("prep_depth"), r.get("frames")
    return t / frames if t and frames else None
