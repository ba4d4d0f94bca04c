"""replayed_share.train (%): the steps of the profiled slice, train and
eval steps alike, that replayed a captured CUDA graph, over all its steps
(the program's counters ``train.steps_replayed`` and
``train.steps_eager``). Layer: ``train/step.py``, ``train/graphs.py``.
Moves ``train_img_per_s``."""


def read(run):
    replayed = run.counters.get("train.steps_replayed", 0)
    steps = replayed + run.counters.get("train.steps_eager", 0)
    return 100.0 * replayed / steps if steps else None
