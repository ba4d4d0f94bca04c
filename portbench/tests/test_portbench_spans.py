"""The program's spans and counters in traced runs: the readers of
``metrics/`` that read them, on hand-made slices with known spans, counters
and device events; the idle gaps' labels; and tiny traced CPU runs of a
serving and a training cell, whose slices carry the program's spans and
counter changes from inside the slice alone. The profiler traces no card
here, so a stand-in for ``trace.DeviceTrace`` gives the device events; the
program's recording is real."""

import threading

import pytest
import torch

from harness import common, manifest, trace
from harness.spans import by_root, idle_in, self_ns
from vae_gan_mark_tpu_torch.utils import profiling
from vae_gan_mark_tpu_torch.utils.profiling import SpanRecord

MS = 10 ** 6
MAIN = threading.main_thread().ident
NEW = ("engine_prep_ms.serve", "engine_dispatch_ms.serve",
       "engine_sync_ms.serve", "replayed_share.serve", "step_idle_ms.train",
       "prefetch_idle_ms_per_step.train", "replayed_share.train")


def rec(name, start_ms, end_ms, id_, parent=0, root=None, thread=MAIN):
    return SpanRecord(name, round(start_ms * MS), round(end_ms * MS), id_,
                      parent, root or id_, thread, {})


def busy(*pairs_ms):
    return [trace.Event("kernel", round(a * MS), round(b * MS))
            for a, b in pairs_ms]


def slice_of(spans, events, counters=None, steps=0, t1_ms=100):
    return common.TracedRun(cfg={}, traffic={}, t0=0, t1=int(t1_ms * MS),
                            events=events, spans=[], window_s=1.0,
                            steps=steps, program_spans=spans,
                            counters=counters or {})


def request(t, id_, prep_ms, forward_ms, copy_out_ms):
    """One request's spans from ``t`` ms: encode, noise and copy in share
    ``prep_ms`` as 2:1:1, then the forward, then the read-back."""
    a, b, c = t + prep_ms / 2, t + prep_ms * 3 / 4, t + prep_ms
    d = c + forward_ms
    e = d + copy_out_ms
    return [rec("serve.encode", t, a, id_ + 1, id_, id_),
            rec("serve.noise", a, b, id_ + 2, id_, id_),
            rec("serve.copy_in", b, c, id_ + 3, id_, id_),
            rec("serve.forward", c, d, id_ + 4, id_, id_),
            rec("serve.copy_out", d, e, id_ + 5, id_, id_),
            rec("serve.request", t, e, id_)]


def serving_slice():
    """Three requests: prep 2, 3, 1 ms; forward 0.5, 0.2, 0.1 ms; a
    read-back of 7.5 ms whose device work ends 0.5, 0.1, 0.3 ms before it
    does (the third with a gap of 0.4 ms between kernels, which is the
    card's). A span whose root lies outside the slice and a root of another
    name count for nothing."""
    spans = (request(0, 10, 2.0, 0.5, 7.5) + request(20, 20, 3.0, 0.2, 7.5)
             + request(40, 30, 1.0, 0.1, 7.5)
             + [rec("serve.encode", 60, 70, 41, 40, 40),
                rec("serve.forward", 70, 71, 51), rec("other", 70, 72, 52)])
    events = busy((2.5, 9.5), (23.2, 30.6), (41.1, 44.0), (44.4, 48.3))
    counters = {"serve.forwards_replayed": 199, "serve.forwards_eager": 1,
                "serve.rows_computed": 200}
    return slice_of(spans, events, counters)


def training_slice():
    """Two train steps: a wait over a busy card (back-pressure), a step
    idle for 5 ms of it, a wait over an idle card (10 ms), a step idle for
    2 ms; 32 replayed and 4 eager steps."""
    spans = [rec("train.prefetch_wait", 0, 10, 2, 1, 1),
             rec("train.step", 10, 40, 3, 1, 1),
             rec("train.prefetch_wait", 40, 50, 4, 1, 1),
             rec("train.step", 50, 80, 5, 1, 1),
             rec("train.epoch", 0, 100, 1)]
    counters = {"train.steps_replayed": 32, "train.steps_eager": 4}
    return slice_of(spans, busy((0, 35), (52, 80)), counters, steps=2)


@pytest.mark.parametrize("name,expected", [
    ("engine_prep_ms.serve", 2.0), ("engine_dispatch_ms.serve", 0.2),
    ("engine_sync_ms.serve", 0.3), ("replayed_share.serve", 99.5)])
def test_serving_readers(name, expected):
    assert manifest.metric_reader(name)(serving_slice()) == \
        pytest.approx(expected, abs=1e-9)


@pytest.mark.parametrize("name,expected", [
    ("step_idle_ms.train", 3.5), ("prefetch_idle_ms_per_step.train", 5.0),
    ("replayed_share.train", 100.0 * 32 / 36)])
def test_training_readers(name, expected):
    assert manifest.metric_reader(name)(training_slice()) == \
        pytest.approx(expected, abs=1e-9)


def test_a_wait_over_a_busy_card_is_back_pressure():
    spans = [rec("train.prefetch_wait", 5, 15, 1)]
    run = slice_of(spans, busy((0, 20)), steps=1)
    assert manifest.metric_reader("prefetch_idle_ms_per_step.train")(
        run) == 0.0
    idle = slice_of(spans, busy((0, 5), (15, 20)), steps=1)
    assert manifest.metric_reader("prefetch_idle_ms_per_step.train")(
        idle) == pytest.approx(10.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_with_nothing_to_read_gives_nothing(name):
    assert manifest.metric_reader(name)(slice_of([], busy((0, 50)),
                                                 steps=4)) is None


def test_span_helpers():
    run = serving_slice()
    groups = by_root(run, "serve.request")
    assert [g[-1].id for g in groups] == [10, 20, 30]
    assert len(by_root(run)) == 5          # and the roots 51 and 52
    parent = rec("p", 0, 10, 1)
    kids = [rec("a", 1, 3, 2, 1, 1), rec("b", 2, 4, 3, 1, 1),
            rec("c", 6, 7, 4, 1, 1), rec("grandchild", 0, 10, 5, 4, 1)]
    assert self_ns(parent, kids) == 6 * MS
    nested = slice_of([rec("w", 0, 10, 1), rec("w", 2, 4, 2, 1, 1)],
                      busy((5, 8)))
    assert idle_in(nested, "w") == 7 * MS


def test_idle_gaps_take_the_innermost_main_thread_span():
    events = busy((0, 10), (20, 35))
    harness = [trace.Span("request", 0, 40 * MS)]
    program = [rec("serve.copy_in", 10, 20, 2, 1, 1),
               rec("elsewhere", 12, 18, 3, thread=MAIN + 1),
               rec("serve.request", 0, 40, 1)]
    gaps = trace.breakdown(events, harness, 0, 40 * MS, program)["idle_gaps"]
    assert [label for label, _ in gaps] == ["request/serve.copy_in",
                                            "request/serve.request"]
    assert [s for _, s in gaps] == [0.01, 0.005]
    bare = trace.breakdown(events, harness, 0, 40 * MS)["idle_gaps"]
    assert [label for label, _ in bare] == ["request", "request"]


class StandInTrace:
    """In place of ``trace.DeviceTrace``: one 1 us kernel at each start."""

    def start(self):
        self.t = trace.now_ns()

    def stop(self):
        return [trace.Event("stand_in_kernel", self.t, self.t + 1000)]


@pytest.mark.parametrize("name", ["v2.serve.patch", "v2.train.graphs"])
def test_traced_run_carries_the_slice_spans_and_counters(tiny_cell,
                                                         monkeypatch, name):
    import run as bench_run
    seen = []
    read = common.read_per_layer

    def spy(cell, run):
        seen.append(run)
        return read(cell, run)

    monkeypatch.setattr(trace, "DeviceTrace", StandInTrace)
    monkeypatch.setattr(common, "read_per_layer", spy)
    cell = tiny_cell(name)
    out = bench_run.run_cell(cell, 2 ** 31 + 23, 1.0, True,
                             torch.device("cpu"), 0)
    assert out["correct"] and out["failed"] == 0
    assert profiling.span("after") is profiling.NO_SPAN
    (run,) = seen
    assert run.program_spans
    assert all(run.t0 <= s.start <= s.end <= run.t1
               for s in run.program_spans)
    tr = cell.traffic
    if tr["kind"] == "serve":
        n = tr["trace_requests"]
        assert len(by_root(run, "serve.request")) == n
        assert run.counters["serve.rows_computed"] == n * tr["engine_batch"]
        assert run.counters["serve.forwards_eager"] == n     # on the CPU
        assert {"engine_prep_ms.serve", "engine_dispatch_ms.serve",
                "engine_sync_ms.serve"} <= set(out["metrics"])
        assert out["metrics"]["replayed_share.serve"]["value"] == 0.0
    else:
        epochs = tr["trace_epochs"]
        assert len(by_root(run, "train.epoch")) == epochs
        assert len(by_root(run, "train.validate")) == epochs
        steps = (tr["train_samples"] + tr["val_samples"]) // tr["batch_size"]
        assert run.counters["train.steps_eager"] == epochs * steps
        assert "train.steps_replayed" not in run.counters
        assert {"step_idle_ms.train", "prefetch_idle_ms_per_step.train",
                "replayed_share.train"} <= set(out["metrics"])
    assert out["extra"]["graph_captures_in_slice"] == 0
