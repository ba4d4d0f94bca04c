"""idle_share.train (%): 1 - device busy / wall time of the profiled
slice, device activity alone in the trace. Layer: the device. Moves
``train_img_per_s``."""


def read(run):
    if not run.events or run.slice_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.slice_s)
