"""val_share.train (%): the share of the window's wall time spent in
``Trainer.validate``, from the harness's host-clock spans around each
call. Layer: ``train/loop.py`` Trainer. Moves ``train_img_per_s``."""


def read(run):
    val = sum(s.end - s.start for s in run.spans if s.label == "validate")
    if not run.spans or run.window_s <= 0:
        return None
    return 100.0 * val / 1e9 / run.window_s
