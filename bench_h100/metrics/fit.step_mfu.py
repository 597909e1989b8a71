"""The whole full-stage iteration's share of the chip's peak: its least
time on the published peaks (``work/fit_step.py``, part by part, on the
scene at the window's end) over the measured time of an iteration
(device/stage over the iterations run), in percent."""


def read(r):
    work, tel, its = r.get("work"), r.get("telemetry"), r.get("iterations")
    if not work or not tel or "device/stage" not in tel or not its:
        return None
    return 100.0 * work["seconds"] / (tel["device/stage"] / its)
