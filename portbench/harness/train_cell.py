"""A training cell: one ``Trainer`` built from the seed, its first steps
checked, then epochs of ``train_epoch`` and ``validate`` for the window.

Set-up builds the Trainer (``multi_step`` from the traffic file) on
device-resident data and the seeded weights, and drives its first steps
through ``train_epoch`` itself, on the window's source cut to the checked
epochs (``checked_epochs``: batches 0, then 1-4 of epoch 0, rows that all
differ): the first a lone step (a trailing group at K > 1), whose gradient
Adam's state gives, the second one group of four (at K=4 its first step
eager, the others captured as a CUDA graph and replayed, as in the
window). It keeps each checked epoch's mean losses, each parameter's
change after them, and the losses of ``validate(0)`` that follows. The
window then runs epoch after epoch, each ``train_epoch(e)`` and
``validate(e)``, until ``--seconds`` have passed at an epoch's end. Once the window has closed and the peak memory is read,
the program's state is freed and the reference runs the checked steps and
the validation from the same weights.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict

import torch

from harness import common, data, flops, manifest, peaks, trace
from harness.compare import decide, train_numbers
from harness.weights import make_state_dicts
from reference.train import TERMS, kl_weight, run_steps


def build_trainer(cell: manifest.Cell, seed: int, device: torch.device):
    from vae_gan_mark_tpu_torch.train.loop import Trainer
    from vae_gan_mark_tpu_torch.train.metrics import NullLogger

    cfg, traffic = cell.config, cell.traffic
    train, val = data.train_sets(cell, seed, device)
    g_sd, d_sd, vgg_sd = make_state_dicts(cell, data.sub_seed(seed, "weights"),
                                          device)
    workdir = tempfile.mkdtemp(prefix="portbench_")
    trainer = Trainer(manifest.port_config(cfg), train, val, workdir,
                      seed=data.sub_seed(seed, "trainer"), device=device,
                      init=(g_sd, d_sd), vgg_state_dict=vgg_sd,
                      logger=NullLogger(), multi_step=traffic["multi_step"])
    return trainer, train, workdir


def _named(trainer) -> Dict[str, torch.nn.Parameter]:
    return {**{f"G.{k}": p for k, p in
               trainer.state.generator.named_parameters()},
            **{f"D.{k}": p for k, p in
               trainer.state.discriminator.named_parameters()}}


def _grad_norms(trainer, named, b1: float) -> Dict[str, float]:
    """Each leaf's first gradient from Adam's state after one step:
    ``exp_avg / (1 - b1)``; 0 for a leaf that Adam holds no state of (no
    gradient reached it)."""
    out = {}
    for k, p in named.items():
        opt = trainer.state.opt_g if k.startswith("G.") \
            else trainer.state.opt_d
        state = opt.state.get(p, {})
        out[k] = float(torch.linalg.vector_norm(
            state["exp_avg"] / (1 - b1))) if "exp_avg" in state else 0.0
    return out


def checked_steps(cell: manifest.Cell, trainer, train) -> dict:
    """The program's checked epochs through ``train_epoch(0)``, then
    ``validate(0)``: each epoch's mean losses, the first step's gradients,
    the parameters' change after the last step, and validation's
    losses."""
    named = _named(trainer)
    start = {k: p.detach().clone() for k, p in named.items()}
    losses, grad1, first = [], {}, 0
    for count in cell.traffic["checked_epochs"]:
        train.only(first, count)
        try:
            out = trainer.train_epoch(0)
        finally:
            train.only(None)
        losses.append({k: float(out[k]) for k in TERMS})
        if first == 0:
            grad1 = _grad_norms(trainer, named, cell.config["adam_b1"])
        first += count
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
              for k, p in named.items()}
    val = {k: float(v) for k, v in trainer.validate(0).items()}
    return {"losses": losses, "grad1": grad1, "change": change, "val": val}


def reference_steps(cell: manifest.Cell, seed: int, device,
                    precision: str = "float32", fault=None) -> dict:
    cfg = cell.config
    train, val = data.train_sets(cell, seed, device)
    g_sd, d_sd, vgg_sd = make_state_dicts(cell, data.sub_seed(seed, "weights"),
                                          device)

    def plain(source, i):
        return {k: v for k, v in source.batch(source.rows(0, i)).items()
                if k != "raw_text"}

    epochs, first = [], 0
    for count in cell.traffic["checked_epochs"]:
        epochs.append([plain(train, i) for i in range(first, first + count)])
        first += count
    with common.float32_scope():
        return run_steps(cell.reference, cfg, g_sd, d_sd, vgg_sd, epochs,
                         [plain(val, i) for i in range(val.steps)],
                         data.sub_seed(seed, "trainer"), kl_weight(cfg, 0),
                         device, precision, fault)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: int) -> dict:
    traffic = cell.traffic
    trainer, train, workdir = build_trainer(cell, seed, device)
    try:
        prog = checked_steps(cell, trainer, train)
        tracer = trace.DeviceTrace() if traced else None
        if tracer is not None:            # the profiler's own start-up
            tracer.start()
            tracer.stop()
            tracer = trace.DeviceTrace()
            program = trace.ProgramTrace()
        common.free_device(device)
        common.settle()
        t_w0 = trace.now_ns()
        setup_s = (t_w0 - t_start) / 1e9
        spans, events, recording = [], [], None
        skip, n_traced = traffic["trace_skip"], traffic["trace_epochs"]
        t_slice = [0, 0]
        steps_per_epoch = train.steps
        attempted = failed = steps = 0
        epoch = 0
        while True:
            if tracer is not None and epoch == skip:
                tracer.start()
                program.start()
                t_slice[0] = trace.now_ns()
            a = trace.now_ns()
            attempted += steps_per_epoch
            try:
                trainer.train_epoch(epoch)
                steps += steps_per_epoch
            except FloatingPointError:
                failed += steps_per_epoch
            b = trace.now_ns()
            trainer.validate(epoch)
            c = trace.now_ns()
            spans += [trace.Span("train_epoch", a, b),
                      trace.Span("validate", b, c)]
            epoch += 1
            if tracer is not None and epoch == skip + n_traced:
                t_slice[1] = trace.now_ns()
                recording = program.stop()
                events = tracer.stop()
                tracer = None
            if failed or ((c - t_w0) / 1e9 >= seconds and (
                    not traced or t_slice[1])):
                break
        window_s = (c - t_w0) / 1e9
        device_info = common.device_record(device, cell.chips)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del trainer, train
    common.free_device(device)

    ref = reference_steps(cell, seed, device)
    numbers = train_numbers(prog, ref)
    correct, checks = decide(numbers, cell.limits)
    correct = correct and not failed
    bs = traffic["batch_size"]
    if not traced:
        metrics = {"train_img_per_s": {"value": steps * bs / window_s,
                                       "unit": "img/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        return dict(correct=correct, attempted=attempted, failed=failed,
                    metrics=metrics, device=device_info, checks=checks,
                    extra={"numbers": numbers})
    t0, t1 = t_slice
    least = peaks.least_seconds(flops.train_step_flops(
        cell.reference, cell.config, bs))
    traced_steps = n_traced * steps_per_epoch
    program_spans = trace.clip_spans(recording.spans, t0, t1) \
        if recording else []
    run_ = common.TracedRun(cfg=cell.config, traffic=traffic, t0=t0, t1=t1,
                            events=events, spans=spans, window_s=window_s,
                            steps=traced_steps, least_unit_s=least,
                            program_spans=program_spans,
                            counters=recording.counters if recording else {})
    device_info["busy_s"] = run_.busy_s
    device_info["window_s"] = run_.slice_s
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=common.read_per_layer(cell, run_), device=device_info,
                checks=checks,
                breakdown=trace.breakdown(events, spans, t0, t1,
                                          program_spans),
                extra={"numbers": numbers, "least_step_s": least,
                       "classes": trace.by_class(
                           trace.clip(events, t0, t1)),
                       "graph_captures_in_slice": run_.graph_captures})
