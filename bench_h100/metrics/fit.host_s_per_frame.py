"""Host seconds a frame of the fit spends outside its stages: the host/*
phases of the Telemetry the driver attached to the trainer (hull
segmentation, diagnostic renders, image writes queued, checkpoints; the
driver's gt IO, attribute check and trajectory eval as fit_video names
them), summed over the window's frames."""


def read(r):
    tel, frames = r.get("telemetry"), r.get("frames")
    if not tel or not frames:
        return None
    return sum(v for k, v in tel.items() if k.startswith("host/")) / frames
