"""engine_dispatch_ms.serve (ms): the median over the profiled slice's
requests of a request's ``serve.forward`` time (the program's span): the
host's issue of the generator's forward, one replay's launch where the
engine replays a captured graph. Layer: ``serve/engine.py``,
``serve/chunks.py``. Moves ``serve_p95_ms``."""

import statistics

from harness.spans import by_root, total_ns


def read(run):
    per = [total_ns(group, "serve.forward")
           for group in by_root(run, "serve.request")]
    return statistics.median(per) / 1e6 if per else None
