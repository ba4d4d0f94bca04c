"""elementwise_ms_per_step.train (ms): device time of the kernels in the
"other elementwise / reduction" class (BatchNorm's statistics, FiLM,
activations, losses: every kernel no other class claims) over the profiled
slice, divided by its train steps. Layer: ``models/``, ``ops/norms.py``,
``ops/film.py``. Moves ``train_img_per_s``."""

from harness.trace import ELEMENTWISE, kernel_class


def read(run):
    if not run.events or not run.steps:
        return None
    ns = sum(e.end - e.start for e in run.events
             if run.t0 <= e.start < run.t1
             and kernel_class(e.name) == ELEMENTWISE)
    return ns / 1e6 / run.steps
