"""engine_prep_ms.serve (ms): the median over the profiled slice's requests
of a request's ``serve.encode`` + ``serve.noise`` + ``serve.copy_in`` time
(the program's spans): tokenise and pad, the chunk's noise, its host
tensors into the device or into the graph's inputs. Layer:
``serve/engine.py``, ``serve/chunks.py``. Moves ``serve_p95_ms``."""

import statistics

from harness.spans import by_root, total_ns

PREP = ("serve.encode", "serve.noise", "serve.copy_in")


def read(run):
    per = [total_ns(group, *PREP) for group in by_root(run, "serve.request")]
    return statistics.median(per) / 1e6 if per else None
