"""Device milliseconds an iteration of the stage loop spends in projection,
binning and compositing (from its start to the compositor's end): the
trainer's ``iter/render``, summed from the stamps that each iteration
writes on the card inside its graph replay
(``gflow_tpu_torch/ops/stamp.py``), over the iterations the window ran.
None where the program records no such stamps."""


def read(r):
    tel, its = r.get("telemetry"), r.get("iterations")
    if not tel or "iter/render" not in tel or not its:
        return None
    return 1e3 * tel["iter/render"] / its
