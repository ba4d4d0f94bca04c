"""The plain reference against the program on the CPU at a tiny geometry
(float32), and the whole of a run, chip check aside, with the timed path
broken underneath: each fault must turn ``correct`` false."""

from itertools import islice

import numpy as np
import pytest
import torch

from harness import serve_cell, train_cell
from harness.compare import decide, serve_numbers, train_numbers

CPU = torch.device("cpu")


def params(state):
    return list(state.generator.parameters()) + \
        list(state.discriminator.parameters())


def _train_numbers(cell, seed):
    trainer, train, _ = train_cell.build_trainer(cell, seed, CPU)
    prog = train_cell.checked_steps(cell, trainer, train)
    ref = train_cell.reference_steps(cell, seed, CPU)
    assert len(prog["losses"]) == len(ref["losses"]) == 2
    assert set(prog["val"]) >= set(ref["val"])
    return train_numbers(prog, ref)


@pytest.mark.parametrize("name", ["v2.train.graphs", "oldv.train.eager"])
def test_reference_follows_the_program_train_steps(tiny_cell, name):
    """With both learning rates 0 every checked number is rounding (float32
    on both sides): the losses of both checked epochs, the first gradients
    and validation. At the configuration's rates Adam moves the leaves
    whose gradient is rounding by the sign of that rounding, so the later
    epochs part by some 1e-3; the run still holds its limits."""
    cell = tiny_cell(name)
    cell.config = dict(cell.config, lr_g=0.0, lr_d=0.0)
    numbers = _train_numbers(cell, 2 ** 31 + 11)
    for key in ("loss_gap", "grad_gap", "text_grad_gap", "val_gap"):
        assert numbers[key]["value"] < 1e-5, (key, numbers[key])
    assert numbers["change_gap"]["value"] == 0.0
    cell = tiny_cell(name)
    numbers = _train_numbers(cell, 2 ** 31 + 11)
    assert numbers["loss1_gap"]["value"] < 1e-5
    assert numbers["grad_gap"]["value"] < 2e-2
    assert decide(numbers, cell.limits)[0]


def test_reference_follows_the_program_serving(tiny_cell):
    cell = tiny_cell("v2.serve.patch")
    pool = serve_cell.make_pool(cell, 5, CPU)
    g_sd, _ = serve_cell.generator_weights(cell, 5, CPU)
    engine = serve_cell.build_engine(cell, 5, g_sd, CPU)
    serve_cell.warm(engine, pool, cell.traffic["engine_batch"])
    rec = serve_cell.window(engine, cell, pool, 5, 2.0)
    pairs = serve_cell.reference_pairs(cell, 5, g_sd, pool,
                                       rec["sample"].items(), CPU)
    numbers = serve_numbers(pairs)
    assert numbers["patch_max_gap"]["value"] < 1e-5
    assert len(pairs) >= 2


def _run(cell, seed=2 ** 31 + 3):
    import run as bench_run
    return bench_run.run_cell(cell, seed, 1.0, False, CPU, 0)


def test_sound_run_is_correct(tiny_cell):
    out = _run(tiny_cell("v2.train.graphs"))
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}


def _broken_step(monkeypatch, fault):
    from vae_gan_mark_tpu_torch.train import loop, step as step_mod
    original = step_mod.build_train_step

    def build(cfg):
        real = original(cfg)

        def step(state, vgg, batch, generator, kl_weight):
            if fault == "half_batch":
                rows = batch["ru"].shape[0] // 2
                batch = {k: v[:rows] for k, v in batch.items()}
            saved = [p.detach().clone() for p in params(state)]
            state, metrics = real(state, vgg, batch, generator, kl_weight)
            if fault == "unchanged":
                with torch.no_grad():
                    for p, s in zip(params(state), saved):
                        p.copy_(s)
            return state, metrics
        return step

    monkeypatch.setattr(step_mod, "build_train_step", build)
    monkeypatch.setattr(loop, "build_train_step", build)


def _reused_batch(monkeypatch):
    """Every step of a group (K > 1), or of an epoch (K = 1), trains on the
    first batch."""
    from vae_gan_mark_tpu_torch.train import loop
    multi = loop.build_multi_train_step

    def build_multi(cfg):
        real = multi(cfg)

        def step(state, vgg, batches, *args, **kw):
            return real(state, vgg, [batches[0]] * len(batches), *args,
                        **kw)
        return step

    prefetch = loop.prefetch_to_device

    def first_only(iterator, put, size=2):
        items = list(prefetch(iterator, put, size))
        for _ in items:
            yield items[0]

    monkeypatch.setattr(loop, "build_multi_train_step", build_multi)
    monkeypatch.setattr(loop, "prefetch_to_device", first_only)


def _doubled_gru_gradient(monkeypatch):
    """The BiGRU backward (the GRU backward kernel's op) returns twice its
    gradients."""
    from vae_gan_mark_tpu_torch.ops import gru
    real = gru.bigru_backward_op

    def doubled(*args):
        return tuple(2.0 * g for g in real(*args))

    monkeypatch.setattr(gru, "bigru_backward_op", doubled)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["v2.train.graphs", "oldv.train.eager"])
def test_training_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    _broken_step(monkeypatch, fault)
    out = _run(tiny_cell(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["reused_batch", "gru_gradient_x2",
                                   "validate_does_nothing"])
@pytest.mark.parametrize("name", ["v2.train.graphs", "oldv.train.eager"])
def test_trainer_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    from vae_gan_mark_tpu_torch.train.loop import Trainer
    if fault == "reused_batch":
        _reused_batch(monkeypatch)
    elif fault == "gru_gradient_x2":
        _doubled_gru_gradient(monkeypatch)
    else:
        monkeypatch.setattr(Trainer, "validate", lambda self, epoch: {})
    out = _run(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    from vae_gan_mark_tpu_torch.serve.engine import InferenceEngine
    real = InferenceEngine._run_chunk

    def altered(self, ru, mask, text, eps):
        out = real(self, ru, mask, text, eps)
        out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(InferenceEngine, "_run_chunk", altered)
    out = _run(tiny_cell("v2.serve.patch"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["v2.train.graphs", "oldv.train.eager"])
def test_control_fails_the_limits(tiny_cell, name):
    """The reference one precision down (float8 for the bf16 group, TF32
    for the float32 group) in the program's place."""
    cell = tiny_cell(name)
    ref = train_cell.reference_steps(cell, 21, CPU)
    ctl = train_cell.reference_steps(cell, 21, CPU, precision="control")
    assert not decide(train_numbers(ctl, ref), cell.limits)[0]


def test_serving_control_fails_the_limits(tiny_cell):
    cell = tiny_cell("v2.serve.patch")
    pool = serve_cell.make_pool(cell, 9, CPU)
    reqs = [(r, None) for r in islice(serve_cell.gen.requests(
        cell.traffic, cell.config["alphabet"], cell.config["max_text_len"],
        9), 6)]
    g_sd, _ = serve_cell.generator_weights(cell, 9, CPU)
    ref = serve_cell.reference_pairs(cell, 9, g_sd, pool, reqs, CPU)
    ctl = serve_cell.reference_pairs(cell, 9, g_sd, pool, reqs, CPU,
                                     "control")
    numbers = serve_numbers([(c, r) for (_, c), (_, r) in zip(ctl, ref)])
    assert np.isfinite(numbers["patch_max_gap"]["value"])
    assert not decide(numbers, cell.limits)[0]
