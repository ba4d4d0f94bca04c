"""The CUDA-graph replay policy (``train/graphs.py:Replayer``) on the CPU: a
stand-in for ``CapturedStep`` and batches whose tensors say they live on a
card, so that the rules run without one. The captures themselves, and the
replays against eager steps, are the ``gpu`` tests of
``tests/test_torch_port_gpu.py`` and ``tests/test_torch_port_tracing.py``.
The file imports no JAX."""

import pytest
import torch

from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.train import graphs
from vae_gan_mark_tpu_torch.utils.profiling import recording

CARD = torch.device("cuda")


class CardTensor:
    """What the replayer reads of a tensor on the card."""

    def __init__(self, *shape, dtype=torch.float32):
        self.shape, self.dtype, self.device = shape, dtype, CARD


def card_batch(rows=2):
    return {"ru": CardTensor(rows, 8, 16, 3),
            "text": CardTensor(rows, 12, dtype=torch.int64)}


@pytest.fixture
def log(monkeypatch):
    """The stand-in captures and the GRU preparations, in order."""
    events = []

    class StandIn:
        def __init__(self, fn, batch, what="the step"):
            self.fn, self.what = fn, what
            self.signature = graphs.batch_signature(batch)
            self.inputs = dict(batch)
            events.append(("capture", self))

        def fits(self, batch):
            return graphs.batch_signature(batch) == self.signature

        def load(self, batch):
            events.append(("load", batch))

    monkeypatch.setattr(graphs, "CapturedStep", StandIn)
    monkeypatch.setattr(gru, "prepare_capture", lambda cfg, rows, backward: (
        events.append(("prepare", (cfg.name, rows, backward)))))
    return events


def drive(replayer, batches, capture, ready=lambda: True):
    """The kinds of steps on ``batches``, each eager one noted."""
    kinds = []
    for batch in batches:
        graph, kind = replayer.get(batch, capture, ready)
        assert (graph is None) == (kind == "eager")
        if graph is None:
            replayer.note_eager(batch)
        kinds.append(kind)
    return kinds


@pytest.mark.parametrize("counter", ["serve.graph_captures",
                                     "train.graph_captures"])
def test_one_signature_runs_eager_then_captures_then_replays(log, counter):
    replayer = graphs.Replayer(get_config("v2"), counter, "the forward")

    def capture(inputs, generator, kl_weight):
        return inputs

    with recording() as rec:
        kinds = drive(replayer, [card_batch() for _ in range(4)], capture)
    assert kinds == ["eager", "capture", "replay", "replay"]
    assert rec.counters == {counter: 1}
    captures = [e for kind, e in log if kind == "capture"]
    assert len(captures) == 1 and captures[0] is replayer.graph
    assert captures[0].fn is capture and captures[0].what == "the forward"


def test_a_batch_that_does_not_fit_runs_eagerly(log):
    replayer = graphs.Replayer(get_config("v2"), "train.graph_captures")
    drive(replayer, [card_batch(), card_batch()], None)
    graph = replayer.graph
    short = card_batch(rows=1)
    assert replayer.load(short) is None
    assert drive(replayer, [short, short, card_batch()], None) == [
        "eager", "eager", "replay"]
    assert replayer.graph is graph
    # A batch loaded into the inputs replays without a second look.
    full = card_batch()
    inputs = replayer.load(full)
    assert inputs is graph.inputs and log[-1] == ("load", full)
    assert replayer.get(inputs, None) == (graph, "replay")


def test_a_capture_waits_until_the_owner_is_ready(log):
    replayer = graphs.Replayer(get_config("v2"), "train.graph_captures")
    batches = [card_batch() for _ in range(3)]
    assert drive(replayer, batches, None, ready=lambda: False) == [
        "eager"] * 3
    assert replayer.graph is None and not log
    assert drive(replayer, batches[:2], None) == ["capture", "replay"]


def test_each_replayer_warms_its_own_signatures(log):
    cfg = get_config("v2")
    first = graphs.Replayer(cfg, "train.graph_captures")
    second = graphs.Replayer(cfg, "train.graph_captures")
    assert drive(first, [card_batch(), card_batch()], None) == [
        "eager", "capture"]
    assert drive(second, [card_batch(), card_batch()], None) == [
        "eager", "capture"]


def test_a_batch_off_the_card_always_runs_eagerly(log):
    replayer = graphs.Replayer(get_config("v2"), "serve.graph_captures")
    batch = {"ru": torch.zeros(2, 8, 16, 3),
             "text": torch.zeros(2, 12, dtype=torch.int64)}
    assert drive(replayer, [batch] * 3, None) == ["eager"] * 3
    assert replayer.graph is None and not log


@pytest.mark.parametrize("backward", [False, True])
def test_the_gru_kernels_are_prepared_before_the_capture(log, backward):
    replayer = graphs.Replayer(get_config("oldv"), "train.graph_captures",
                               backward=backward)
    drive(replayer, [card_batch(rows=3)] * 3, None)
    assert [kind for kind, _ in log] == ["prepare", "capture"]
    assert log[0][1] == ("oldv", 3, backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("variant", ["v2", "oldv", "vanilla"])
def test_prepare_capture_prepares_the_kernels_the_config_launches(
        monkeypatch, variant, backward):
    """The char text paths (v2, oldv) launch the GRU forward, and in a
    train step its backward; the sbert path (vanilla) launches neither."""
    cfg = get_config(variant)
    prepared = []
    for name in ("KERNEL", "BACKWARD_KERNEL"):
        monkeypatch.setattr(getattr(gru, name), "prepare",
                            lambda rows, hidden, name=name: prepared.append(
                                (name, rows, hidden)))
    gru.prepare_capture(cfg, 16, backward)
    expected = [("KERNEL", 16, cfg.char_rnn_hidden)]
    if backward:
        expected.append(("BACKWARD_KERNEL", 16, cfg.char_rnn_hidden))
    assert prepared == ([] if variant == "vanilla" else expected)
