"""Per-layer metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``.  Each declares ``LAYER``, ``UNIT``, ``SOURCE`` and
``MOVES`` and reads the traced run (``rxbench.tracing.Traced``) with
``read(traced)``, which returns None where it finds nothing to read: the
harness then leaves the metric out of the line."""
