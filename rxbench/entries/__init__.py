"""The loops that drive one entry of the port each, found by the name a
traffic mix gives.  Each has ``setup(run) -> session`` (the port's object
made and warmed up, the check's start recorded), and the session
``window(seconds, sample_times)``, ``trace_slice()`` and ``release()``;
and ``check(run, data) -> [(kind, readings)]`` against the plain
reference."""
