"""prefetch_idle_ms_per_step.train (ms): the device's idle time inside the
program's ``train.prefetch_wait`` spans (the Trainer waiting for its next
batch or group) over the profiled slice, divided by its train steps: the
card starved by the data source. A wait during which the card is busy is
back-pressure and counts for nothing. Layer: ``train/loop.py`` Trainer.
Moves ``train_img_per_s``."""

from harness.spans import idle_in, named


def read(run):
    if not run.events or not run.steps or \
            not named(run, "train.prefetch_wait"):
        return None
    return idle_in(run, "train.prefetch_wait") / 1e6 / run.steps
