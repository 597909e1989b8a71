"""The general part of the port's H100 benchmark: the manifest and the
files found by name, the device's description and peaks, spans, the
profiler window, the guard against the JAX package, and the run's last
line. Nothing here knows a configuration, a traffic mix or a metric."""
