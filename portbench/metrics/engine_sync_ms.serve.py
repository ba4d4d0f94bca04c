"""engine_sync_ms.serve (ms): the median over the profiled slice's requests
of the time inside a request's ``serve.copy_out`` span (the program's span
around ``recon.cpu().numpy()``) after the device's last activity in it
ended: the read-back's host cost once the card has finished (the wake from
the wait, the copy out of the staging buffer, the array). The gaps between
the forward's kernels inside the span are the card's, and count for
nothing. Layer: ``serve/engine.py``, ``serve/chunks.py``. Moves
``serve_p95_ms``."""

import bisect
import statistics

from harness.spans import by_root
from harness.trace import intervals


def read(run):
    if not run.events:
        return None
    busy = intervals(run.events)
    starts = [a for a, _ in busy]

    def tail(s):
        i = bisect.bisect_left(starts, s.end) - 1
        last = busy[i][1] if i >= 0 else s.start
        return s.end - min(max(last, s.start), s.end)

    per = [sum(tail(s) for s in group if s.name == "serve.copy_out")
           for group in by_root(run, "serve.request")]
    return statistics.median(per) / 1e6 if per else None
