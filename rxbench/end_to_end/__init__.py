"""End-to-end metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``: ``read(window)`` from the run's set-up seconds and its
window (``window_s``, ``frames``, ``latencies_s``, ``stream_steps``), None
where the window holds nothing it reads."""
