"""device_ms_per_step.train (ms): the device's busy time over the profiled
slice (validation included) divided by the train steps in it. Layer:
``train/step.py`` and ``train/graphs.py``. Moves ``train_img_per_s``."""


def read(run):
    if not run.events or not run.steps:
        return None
    return 1e3 * run.busy_s / run.steps
