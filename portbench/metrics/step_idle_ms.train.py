"""step_idle_ms.train (ms): the device's idle time inside the program's
``train.step`` spans (the host's issue of one train step, eager or a
replay) over the profiled slice, divided by its train steps: the card
waiting on the step's dispatch. Layer: ``train/step.py``,
``train/graphs.py``. Moves ``train_img_per_s``."""

from harness.spans import idle_in, named


def read(run):
    if not run.events or not run.steps or not named(run, "train.step"):
        return None
    return idle_in(run, "train.step") / 1e6 / run.steps
