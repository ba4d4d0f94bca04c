"""mfu.train (%): the least time of the train steps done in the profiled
slice (the reference's operations, counted once on the meta device and
split by the precision the configuration states, at the card's peaks:
``harness/flops.py``, ``harness/peaks.py``) over the slice's wall time.
Layer: the whole train step. Moves ``train_img_per_s``."""


def read(run):
    if not run.steps or run.slice_s <= 0 or not run.least_unit_s:
        return None
    return 100.0 * run.least_unit_s * run.steps / run.slice_s
