"""gru_roofline.train (%): the GRU kernels' least time over their device
time in the profiled slice. Each ``gru_fwd_kernel`` launch is one BiGRU
layer's forward, both directions; each ``gru_bwd_kernel`` launch one
layer's backward recurrence, both directions (``harness/peaks.py`` counts
their operations and bytes at L = max_text_len, B = batch_size, H =
char_rnn_hidden). Layer: ``ops/gru.py``, ``csrc/gru_fwd.cu``,
``csrc/gru_bwd.cu``. Moves ``train_img_per_s``."""

from harness.peaks import gru_backward_launch, gru_forward_launch

KERNELS = {"gru_fwd_kernel": gru_forward_launch,
           "gru_bwd_kernel": gru_backward_launch}


def read(run):
    shape = (run.cfg["max_text_len"], run.traffic["batch_size"],
             run.cfg["char_rnn_hidden"])
    least = spent = 0.0
    for e in run.events:
        for pattern, bound in KERNELS.items():
            if pattern in e.name and run.t0 <= e.start < run.t1:
                least += bound(*shape)
                spent += (e.end - e.start) / 1e9
    return 100.0 * least / spent if spent else None
