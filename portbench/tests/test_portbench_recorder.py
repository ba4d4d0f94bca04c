"""A ``--trace 0`` run never turns on the program's span recorder
(``vae_gan_mark_tpu_torch/utils/profiling.py``): the cell runs the
harness's own call path on the CPU at a tiny geometry with the recorder's
``start`` made to raise, and still gives its result."""

import pytest
import torch

from vae_gan_mark_tpu_torch.utils import profiling


@pytest.mark.parametrize("name", ["v2.train.graphs", "v2.serve.patch"])
def test_untraced_run_never_starts_the_recorder(tiny_cell, monkeypatch,
                                                name):
    import run as bench_run

    def refuse():
        raise AssertionError("the recorder was started in a --trace 0 run")

    monkeypatch.setattr(profiling, "start", refuse)
    out = bench_run.run_cell(tiny_cell(name), 2 ** 31 + 5, 1.0, False,
                             torch.device("cpu"), 0)
    assert out["correct"] and out["failed"] == 0
    assert profiling.span("after") is profiling.NO_SPAN
