"""Milliseconds an iteration of the stage loop takes: the Telemetry's
device/stage phase (it ends in the stage's batched pull to the host, so it
holds the stage's device time) over the iterations the window ran."""


def read(r):
    tel, its = r.get("telemetry"), r.get("iterations")
    if not tel or "device/stage" not in tel or not its:
        return None
    return 1e3 * tel["device/stage"] / its
