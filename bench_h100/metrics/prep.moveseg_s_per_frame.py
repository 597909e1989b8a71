"""Seconds a frame of the prior preparation spends in prep_moveseg (the
LMedS with small_eig on the card, SciPy's morphology, the mask files): the
driver's span over the frames of the window's sequences."""


def read(r):
    t, frames = r.get("spans", {}).get("prep_moveseg"), r.get("frames")
    return t / frames if t and frames else None
