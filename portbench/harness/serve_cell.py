"""A serving cell: one client in a closed loop calls
``InferenceEngine.generate`` for the window.

Set-up makes the generator's weights and a pool of patches from the seed,
sets every BatchNorm's running statistics to the batch statistics of one
seeded batch of ``CALIB_ROWS`` patches (the reference in train mode: the
eval-mode statistics a trained generator would carry, without which an
eval-mode forward of random weights fades to a constant patch), builds the
engine on that state dict and warms it with two requests of one chunk.
That statistics pass is the reference's work: its seconds are left out of
``setup_s``. Each request is timed from the client's call to its host
arrays coming back; a request that raises counts as failed. A sample of
the finished requests, drawn from the seed by reservoir sampling, and the
longest one, are kept with their patches; once the window has closed and
the peak memory is read the engine is freed and the reference serves the
same rows, texts and noise from the same state dict.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from harness import common, data, flops, manifest, peaks, trace
from harness import traffic as gen
from harness.compare import decide, serve_numbers
from harness.weights import make_state_dicts
from reference.model import BatchNorm, set_precision
from reference.serve import serve_rows


def make_pool(cell: manifest.Cell, seed: int, device):
    pool = data.patches(cell.config, cell.traffic["pool_patches"],
                        data.sub_seed(seed, "data"), device)
    return pool["ru"].cpu().numpy(), pool["mask"].cpu().numpy()


CALIB_ROWS = 16


def generator_weights(cell: manifest.Cell, seed: int, device):
    """(G's state dict with every BatchNorm's running statistics set to one
    seeded batch's (momentum 1), the seconds that statistics pass took)."""
    cfg, arch = cell.config, cell.reference
    g_sd, _, _ = make_state_dicts(cell, data.sub_seed(seed, "weights"),
                                  device)
    t0 = time.perf_counter()
    g = arch.Generator(cfg)
    g.load_state_dict(g_sd)
    g.to(device).train()
    for m in g.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
    batch = data.patches(cfg, CALIB_ROWS, data.sub_seed(seed, "calib"),
                         device)
    text = arch.text_inputs(cfg, data.texts(cfg, CALIB_ROWS, data.sub_seed(
        seed, "calib")), device)
    gen = torch.Generator(device=device).manual_seed(
        data.sub_seed(seed, "calib"))
    with torch.no_grad(), common.float32_scope():
        g(batch["ru"], batch["mask"], text, generator=gen)
    g_sd.update({k: v.detach().clone() for k, v in g.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))})
    del g, batch, text
    common.free_device(device)
    return g_sd, time.perf_counter() - t0


def build_engine(cell: manifest.Cell, seed: int, g_sd: dict, device):
    from vae_gan_mark_tpu_torch.serve.engine import InferenceEngine
    return InferenceEngine(manifest.port_config(cell.config), weights=g_sd,
                           batch_size=cell.traffic["engine_batch"],
                           seed=data.sub_seed(seed, "engine"), device=device)


class Sample:
    """A uniform sample of ``k`` finished requests (reservoir sampling from
    the seed) and the longest one."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.kept: List[Tuple] = []
        self.longest = None
        self.seen = 0

    def offer(self, req, out: np.ndarray) -> None:
        item = (req, out)
        if self.longest is None or req.size > self.longest[0].size:
            self.longest = item
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1

    def items(self) -> List[Tuple]:
        items = list(self.kept)
        if self.longest is not None and all(
                it[0].index != self.longest[0].index for it in items):
            items.append(self.longest)
        return items


def window(engine, cell: manifest.Cell, pool, seed: int, seconds: float,
           tracer=None):
    """The closed loop; returns its record. With a ``tracer`` (a
    ``DeviceTrace``) the device and the program's spans are recorded over
    the traced requests alone."""
    tr = cell.traffic
    cfg = cell.config
    ru_pool, mask_pool = pool
    sample = Sample(tr["check_requests"], data.sub_seed(seed, "sample"))
    stream = gen.requests(tr, cfg["alphabet"], cfg["max_text_len"],
                          data.sub_seed(seed, "traffic"))
    latencies, spans, traced = [], [], []
    attempted = failed = patches = 0
    skip, n_traced = tr["trace_skip"], tr["trace_requests"]
    t_slice = [0, 0]
    program = trace.ProgramTrace() if tracer is not None else None
    t_w0 = trace.now_ns()
    t_end = t_w0
    while True:
        req = next(stream)
        ru = ru_pool[req.offset:req.offset + req.size]
        mask = mask_pool[req.offset:req.offset + req.size]
        if tracer is not None and req.index == skip:
            tracer.start()
            program.start()
            t_slice[0] = trace.now_ns()
        attempted += 1
        a = trace.now_ns()
        t0 = time.perf_counter()
        try:
            out = engine.generate(ru, mask, req.texts)
        except Exception as e:  # a request that raises is a failed request
            print(f"request {req.index} raised {e!r}", flush=True)
            out = None
        t1 = time.perf_counter()
        t_end = b = trace.now_ns()
        spans.append(trace.Span("request", a, b))
        if out is None:
            failed += 1
        else:
            latencies.append(t1 - t0)
            patches += req.size
            sample.offer(req, out)
            if tracer is not None and skip <= req.index < skip + n_traced:
                traced.append((a, b, req.size))
        if tracer is not None and req.index == skip + n_traced - 1:
            t_slice[1] = trace.now_ns()
            recording = program.stop()
            events = tracer.stop()
            tracer = None
        if (t_end - t_w0) / 1e9 >= seconds and (
                t_slice[1] or t_slice[0] == 0 and tracer is None):
            break
    rec = dict(latencies=latencies, spans=spans, attempted=attempted,
               failed=failed, patches=patches, window_s=(t_end - t_w0) / 1e9,
               sample=sample, traced=traced, t_slice=t_slice)
    rec["events"] = events if t_slice[1] else []
    rec["program_spans"] = trace.clip_spans(recording.spans, *t_slice) \
        if t_slice[1] else []
    rec["counters"] = recording.counters if t_slice[1] else {}
    return rec


def reference_pairs(cell: manifest.Cell, seed: int, g_sd: dict, pool,
                    items, device, precision: str = "float32"):
    """(program patches, reference patches) of each sampled request."""
    cfg, arch = cell.config, cell.reference
    g = arch.Generator(cfg)
    g.load_state_dict(g_sd)
    g.to(device)
    set_precision([g], precision)
    ru_pool, mask_pool = pool
    pairs = []
    with common.float32_scope():
        for req, out in items:
            ref = serve_rows(g, cfg, ru_pool[req.offset:req.offset + req.size],
                             mask_pool[req.offset:req.offset + req.size],
                             arch.text_inputs(cfg, req.texts, device),
                             data.sub_seed(seed, "engine"),
                             cell.traffic["engine_batch"], device)
            pairs.append((out, ref))
    return pairs


def warm(engine, pool, chunk: int) -> None:
    """Two requests of one chunk: the engine's only shape."""
    ru, mask = pool
    for _ in range(2):
        engine.generate(ru[:chunk], mask[:chunk], ["warm up"] * chunk)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: int) -> dict:
    pool = make_pool(cell, seed, device)
    g_sd, stats_s = generator_weights(cell, seed, device)
    if device.type == "cuda":      # the peak is the program's, not set-up's
        torch.cuda.reset_peak_memory_stats(device)
    engine = build_engine(cell, seed, g_sd, device)
    g_sd = {k: v.cpu() for k, v in g_sd.items()}
    warm(engine, pool, cell.traffic["engine_batch"])
    tracer = None
    if traced:
        tracer = trace.DeviceTrace()       # the profiler's own start-up
        tracer.start()
        tracer.stop()
        tracer = trace.DeviceTrace()
    common.free_device(device)
    common.settle()
    setup_s = (trace.now_ns() - t_start) / 1e9 - stats_s
    rec = window(engine, cell, pool, seed, seconds, tracer)
    device_info = common.device_record(device, cell.chips)
    del engine
    common.free_device(device)

    pairs = reference_pairs(cell, seed, g_sd, pool, rec["sample"].items(),
                            device)
    numbers = serve_numbers(pairs)
    correct, checks = decide(numbers, cell.limits)
    correct = correct and not rec["failed"]
    extra = {"numbers": numbers, "requests": rec["attempted"],
             "checked_requests": len(pairs), "stats_s": stats_s}
    if not traced:
        metrics = {
            "serve_img_per_s": {"value": rec["patches"] / rec["window_s"],
                                "unit": "img/s"},
            "serve_p95_ms": {"value": float(np.percentile(
                rec["latencies"], 95)) * 1e3 if rec["latencies"]
                else float("inf"), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        return dict(correct=correct, attempted=rec["attempted"],
                    failed=rec["failed"], metrics=metrics, device=device_info,
                    checks=checks, extra=extra)
    t0, t1 = rec["t_slice"]
    least = peaks.least_seconds(flops.generate_flops_per_patch(
        cell.reference, cell.config, cell.traffic["engine_batch"]))
    run_ = common.TracedRun(cfg=cell.config, traffic=cell.traffic, t0=t0,
                            t1=t1, events=rec["events"], spans=rec["spans"],
                            window_s=rec["window_s"],
                            requests=rec["traced"], least_unit_s=least,
                            program_spans=rec["program_spans"],
                            counters=rec["counters"])
    device_info["busy_s"] = run_.busy_s
    device_info["window_s"] = run_.slice_s
    extra.update(least_patch_s=least,
                 classes=trace.by_class(trace.clip(rec["events"], t0, t1)),
                 graph_captures_in_slice=run_.graph_captures)
    return dict(correct=correct, attempted=rec["attempted"],
                failed=rec["failed"],
                metrics=common.read_per_layer(cell, run_), device=device_info,
                checks=checks,
                breakdown=trace.breakdown(rec["events"], rec["spans"], t0, t1,
                                          rec["program_spans"]),
                extra=extra)
