"""A frozen copy of the port's plain versions of the per-frame fit, the
plain reference of the fit cell: projection, binning with its
plain tail, the plain tile compositor (autograd backward), losses, Adam,
densify, from ``gflow_tpu_torch`` at the commit that defined the benchmark
(``core/camera.py``, ``core/scene.py``, ``opt/losses.py``, ``opt/state.py``,
``opt/densify.py``, ``ops/projection.py``, ``ops/binning.py``,
``ops/composite.py``, ``ops/reference.py`` as ``tiles.py``), with its
imports made local and the binning tail always the plain version. It
imports nothing of the program, so a later change of the program leaves
the reference as it is; ``stage.py`` follows one stage step by step.
Every operation runs on the device it is given, in float32."""
