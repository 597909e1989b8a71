"""Device milliseconds an iteration of the stage loop spends in the losses
(from the compositor's end to the forward's end: SSIM and the other terms):
the trainer's ``iter/loss``, summed from the stamps that each iteration
writes on the card inside its graph replay
(``gflow_tpu_torch/ops/stamp.py``), over the iterations the window ran.
None where the program records no such stamps."""


def read(r):
    tel, its = r.get("telemetry"), r.get("iterations")
    if not tel or "iter/loss" not in tel or not its:
        return None
    return 1e3 * tel["iter/loss"] / its
