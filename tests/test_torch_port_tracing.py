"""The port's spans and counters (``utils/profiling.py``) on the CPU at the
tiny geometry: the recorder itself (off by default, the parent and root
links, threads, the clock), the spans of ``InferenceEngine.generate`` and
of ``Trainer.train_epoch`` / ``validate``, and a run with the recorder on
that equals one with it off bit for bit. The replay and capture counters
need a card: the ``gpu`` test at the end. The file imports no JAX, so the
card's machine runs it too."""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.train.loop import Trainer
from vae_gan_mark_tpu_torch.train.state import init_state_dicts
from vae_gan_mark_tpu_torch.utils import profiling
from vae_gan_mark_tpu_torch.utils.profiling import count, recording, span

# The tiny geometry of tests/torch_port_common.py, which imports JAX.
TINY = dict(patch_h=32, patch_w=64, compute_dtype="float32",
            enc_chans=(8, 16, 24, 32), bottleneck_ch=48, z_ch=16,
            char_emb_dim=16, char_rnn_hidden=16, max_text_len=12)
CFG = dict(TINY, batch_size=2)
CHUNK = ("serve.encode", "serve.noise", "serve.copy_in", "serve.forward",
         "serve.copy_out")


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_by_default_records_nothing():
    assert span("a") is profiling.NO_SPAN
    assert span("b", rows=3) is profiling.NO_SPAN
    with span("a") as s:
        s.set(kind="eager")
    before = profiling.counters().get("test.off", 0)
    count("test.off", 2)               # counters are always on
    assert profiling.counters()["test.off"] == before + 2
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert span("c") is profiling.NO_SPAN      # off again after the block


def test_parents_roots_and_threads():
    seen = {}

    def worker():
        with span("thread.outer"):
            with span("thread.inner"):
                seen["ident"] = threading.get_ident()

    with recording() as rec:
        with span("root", epoch=3):
            with span("child") as child:
                child.set(kind="replay")
                with span("grandchild"):
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join()
            with span("second"):
                pass
        with span("another root"):
            pass
    named = {s.name: s for s in rec.spans}
    root = named["root"]
    assert root.parent == 0 and root.root == root.id
    assert root.attrs == {"epoch": 3}
    assert named["child"].parent == root.id
    assert named["child"].attrs == {"kind": "replay"}
    assert named["grandchild"].parent == named["child"].id
    assert named["second"].parent == root.id
    for name in ("child", "grandchild", "second"):
        assert named[name].root == root.id
        assert named[name].thread == threading.get_ident()
    # The thread's spans have a stack of their own.
    outer, inner = named["thread.outer"], named["thread.inner"]
    assert outer.parent == 0 and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.thread == inner.thread == seen["ident"]
    assert seen["ident"] != threading.get_ident()
    other = named["another root"]
    assert other.parent == 0 and other.root == other.id != root.id
    assert len({s.id for s in rec.spans}) == len(rec.spans) == 7


def test_threads_lose_no_count():
    """Eight threads add to one counter with a short switch interval, so
    that they interleave inside ``count``; no addition is lost."""
    before = profiling.counters().get("test.threads", 0)

    def worker():
        for _ in range(5000):
            count("test.threads")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["test.threads"] == before + 8 * 5000


def test_both_ends_on_the_wall_clock():
    with recording() as rec:
        t0 = time.time_ns()
        with span("timed"):
            time.sleep(0.002)
        t1 = time.time_ns()
    (s,) = rec.spans
    assert t0 <= s.start and s.start + 2_000_000 <= s.end <= t1


def test_recordings_nest_and_count_their_own_block():
    with recording() as outer:
        count("test.nest")
        with span("first"):
            pass
        with recording() as inner:
            count("test.nest", 3)
            with span("second"):
                pass
        assert span("third") is not profiling.NO_SPAN
        with span("third"):
            pass
    assert [s.name for s in inner.spans] == ["second"]
    assert inner.counters == {"test.nest": 3}
    assert [s.name for s in outer.spans] == ["first", "second", "third"]
    assert outer.counters == {"test.nest": 4}
    with pytest.raises(RuntimeError):
        profiling.stop()


def test_generate_spans_and_row_counters():
    """3 rows at engine batch 2: one ``serve.request`` with two chunks of
    five spans each, all under it; 3 rows requested, 4 computed, and both
    chunks' forwards eager (a CPU engine captures no graph)."""
    cfg = get_config("v2", **TINY)
    g_sd, _ = init_state_dicts(cfg, 0)
    engine = InferenceEngine(cfg, g_sd, batch_size=2, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    ru = rng.random((3, cfg.patch_h, cfg.patch_w, 3), np.float32)
    mask = rng.random((3, cfg.patch_h, cfg.patch_w, 1), np.float32)
    with recording() as rec:
        out = engine.generate(ru, mask, ["AB", "CDE", "F"])
    assert out.shape == (3, cfg.patch_h, cfg.patch_w, 3)
    (req,) = by_name(rec.spans, "serve.request")
    assert req.parent == 0 and req.attrs == {"rows": 3}
    children = [s for s in rec.spans if s is not req]
    assert sorted(s.name for s in children) == sorted(CHUNK * 2)
    for s in children:
        assert s.parent == req.id and s.root == req.id
        assert req.start <= s.start <= s.end <= req.end
    in_order = sorted(children, key=lambda s: s.start)
    assert [s.name for s in in_order] == list(CHUNK * 2)
    assert rec.counters == {"serve.rows_requested": 3,
                            "serve.rows_computed": 4,
                            "serve.forwards_eager": 2}


def sources(cfg, steps, val_batches):
    train_ds = SyntheticPatchDataset(cfg, 2 * steps, seed=0)
    val_ds = SyntheticPatchDataset(cfg, 2 * val_batches, seed=1)

    def train_data(epoch):
        for i in range(steps):
            yield train_ds.batch(2, i)

    def val_data(epoch):
        for i in range(val_batches):
            yield val_ds.batch(2, i)

    return train_data, val_data


def make_trainer(tmp_path, multi_step=1, steps=3, val_batches=2):
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg, steps, val_batches)
    return Trainer(cfg, train_data, val_data, str(tmp_path), seed=0,
                   device="cpu", multi_step=multi_step)


@pytest.mark.parametrize("multi_step", [1, 2])
def test_epoch_and_validate_spans(tmp_path, multi_step):
    """One ``train_epoch`` of 3 steps and ``validate`` of 2 batches. On the
    CPU every step runs eagerly, at K=2 too (a group of two and a
    trailing single step)."""
    trainer = make_trainer(tmp_path, multi_step)
    with recording() as rec:
        trainer.train_epoch(0)
        trainer.validate(0)
    (epoch,) = by_name(rec.spans, "train.epoch")
    (val,) = by_name(rec.spans, "train.validate")
    assert epoch.parent == 0 and epoch.attrs == {"epoch": 0}
    assert val.parent == 0 and epoch.end <= val.start
    steps = by_name(rec.spans, "train.step")
    waits = by_name(rec.spans, "train.prefetch_wait")
    reads = by_name(rec.spans, "train.epoch_read")
    assert len(steps) == 3 and len(reads) == 1
    # One wait a batch (K=1) or a group (K=2), and one for the end.
    assert len(waits) == (4 if multi_step == 1 else 3)
    for s in steps + waits + reads:
        assert s.root == epoch.id
        assert epoch.start <= s.start <= s.end <= epoch.end
    assert all(s.attrs == {"kind": "eager"} for s in steps)
    assert reads[0].start >= max(s.end for s in steps)
    evals = by_name(rec.spans, "train.eval_step")
    val_reads = by_name(rec.spans, "train.val_read")
    assert len(evals) == 2 and len(val_reads) >= 1
    for s in evals + val_reads:
        assert s.root == val.id
    assert all(s.attrs == {"kind": "eager"} for s in evals)
    assert rec.counters == {"train.steps_eager": 5}
    names = {s.name for s in rec.spans}
    assert names == {"train.epoch", "train.prefetch_wait", "train.step",
                     "train.epoch_read", "train.validate",
                     "train.eval_step", "train.val_read"}


def _run(tmp_path, on: bool):
    torch.manual_seed(0)
    trainer = make_trainer(tmp_path)
    cfg = trainer.cfg
    engine = InferenceEngine(cfg, trainer.state.generator.state_dict(),
                             batch_size=2, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    ru = rng.random((3, cfg.patch_h, cfg.patch_w, 3), np.float32)
    mask = rng.random((3, cfg.patch_h, cfg.patch_w, 1), np.float32)
    with recording() if on else contextlib.nullcontext():
        train = trainer.train_epoch(0)
        val = trainer.validate(0)
        patches = engine.generate(ru, mask, ["AB", "C", "DEF"])
    params = {k: v.detach().clone() for k, v in
              trainer.state.generator.state_dict().items()}
    params.update({f"D.{k}": v.detach().clone() for k, v in
                   trainer.state.discriminator.state_dict().items()})
    train.pop("images_per_sec")
    return train, val, patches, params


def test_recorder_changes_nothing(tmp_path):
    """Losses, patches and parameters with the recorder on equal those
    with it off, bit for bit."""
    off = _run(tmp_path / "off", False)
    on = _run(tmp_path / "on", True)
    assert on[0] == off[0] and on[1] == off[1]
    assert np.array_equal(on[2], off[2])
    assert set(on[3]) == set(off[3])
    for key in off[3]:
        assert torch.equal(on[3][key], off[3][key]), key


@pytest.mark.gpu
def test_replays_and_captures_are_counted_on_card(tmp_path):
    """K=4 on the card, 8 train and 4 val batches, nothing warm: a train
    step eager, the next captured and replayed, six replays; an eval step
    eager, one captured, two replays. Each span's ``kind`` agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)

    card = torch.device("cuda")
    cfg = get_config("v2", **dict(CFG, batch_size=4))
    train = DeviceResidentSynthetic(SyntheticPatchDataset(cfg, 32), 4, 8,
                                    device=card)
    val = DeviceResidentSynthetic(SyntheticPatchDataset(cfg, 16, seed=1), 4,
                                  4, advance_per_epoch=False, device=card)
    trainer = Trainer(cfg, train, val, str(tmp_path), seed=0, device=card,
                      multi_step=4)
    with recording() as rec:
        trainer.train_epoch(0)
        trainer.validate(0)
    torch.cuda.synchronize()
    assert rec.counters == {"train.steps_eager": 2,
                            "train.steps_replayed": 10,
                            "train.graph_captures": 2}
    kinds = [s.attrs["kind"] for s in sorted(
        by_name(rec.spans, "train.step"), key=lambda s: s.start)]
    assert kinds == ["eager", "capture"] + ["replay"] * 6
    kinds = [s.attrs["kind"] for s in sorted(
        by_name(rec.spans, "train.eval_step"), key=lambda s: s.start)]
    assert kinds == ["eager", "capture", "replay", "replay"]
