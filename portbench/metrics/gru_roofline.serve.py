"""gru_roofline.serve (%): as gru_roofline.train, forward launches only
(each one BiGRU layer, both directions, at B = engine_batch). Layer:
``ops/gru.py``, ``csrc/gru_fwd.cu``. Moves ``serve_img_per_s``."""

from harness.peaks import gru_forward_launch


def read(run):
    shape = (run.cfg["max_text_len"], run.traffic["engine_batch"],
             run.cfg["char_rnn_hidden"])
    least = spent = 0.0
    for e in run.events:
        if "gru_fwd_kernel" in e.name and run.t0 <= e.start < run.t1:
            least += gru_forward_launch(*shape)
            spent += (e.end - e.start) / 1e9
    return 100.0 * least / spent if spent else None
