"""engine_host_ms.serve (ms): the median over the profiled slice's requests
of a request's wall time minus the device's busy time inside it: the
engine's host work (tokenise, chunk, pad, copies, ``.cpu()``) and waits.
Layer: ``serve/engine.py``, ``serve/chunks.py``. Moves ``serve_p95_ms``."""

import statistics

from harness.trace import busy_ns


def read(run):
    if not run.events or not run.requests:
        return None
    host = [((b - a) - busy_ns(run.events, a, b)) / 1e6
            for a, b, _ in run.requests]
    return statistics.median(host)
