"""Device milliseconds between iterations of the stage loop: the trainer's
``iter/between``, from each iteration's last stamp to the next one's first
within a stage (``gflow_tpu_torch/ops/stamp.py``: the rebinning graphs,
eager densify and any gap of the host's launches run there), over the
iterations the window ran. None where the program records no such
stamps."""


def read(r):
    tel, its = r.get("telemetry"), r.get("iterations")
    if not tel or "iter/between" not in tel or not its:
        return None
    return 1e3 * tel["iter/between"] / its
