"""replayed_share.serve (%): the generator forwards of the profiled slice
that replayed a captured CUDA graph, over all its forwards (the program's
counters ``serve.forwards_replayed`` and ``serve.forwards_eager``). Layer:
``serve/engine.py``, ``serve/chunks.py``. Moves ``serve_img_per_s``."""


def read(run):
    replayed = run.counters.get("serve.forwards_replayed", 0)
    forwards = replayed + run.counters.get("serve.forwards_eager", 0)
    return 100.0 * replayed / forwards if forwards else None
