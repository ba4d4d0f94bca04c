"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. require CUDA and print the card's name and power limit;
2. build the three kernels (``vae_gan_mark_tpu_torch/csrc/gru_fwd.cu``,
   ``gru_bwd.cu``, ``conv3x3.cu``) with ``nvcc`` for ``sm_90a`` from the
   checkout's sources, one ``nvcc`` each, all at once, and print each one's
   registers, spills and any wgmma serialisation warning;
3. GRU forward: hold the kernel against its plain PyTorch version at L=60,
   H in {16, 256}, B in {1, 16, 128}, float32 with TF32 off, each
   direction alone and both directions of a layer in one launch; print
   ``cudaOccupancyMaxActiveClusters`` and the waves; at H=256, B=16 and
   128, time the pair, one direction, cuDNN's bidirectional ``nn.GRU``
   forward on the same x_proj, the plain pair and the bound; time the
   pair at B=16 over the first 1, 15, 30 and 60 steps and fit the time per
   step and the intercept;
4. GRU backward: the same shapes for dx_proj, dW_hh and db_hh against the
   plain backward, each direction alone and both directions of a layer in
   one launch; print ``cudaOccupancyMaxActiveClusters``; at H=256, B=16
   and 128, time the pair's backward (kernel and its products), the kernel
   alone, one direction's backward, forward + backward through the
   bidirectional autograd function, the plain backwards, cuDNN's
   bidirectional backward and forward + backward, and the bound;
5. conv3x3 (tensor-core implicit GEMM): hold the kernel against
   ``F.conv2d`` at the probe's check shapes and at a width that is not a
   multiple of its tile, drive it once at each of the probe's two benchmark
   shapes (counting launches), and time it there against the plain
   version, cuDNN's bf16 channels-last ``F.conv2d`` and the bound (TFLOP/s,
   bound/ms, kernel/cuDNN);
6. serve the v2 generator at full width (448x64) through
   ``InferenceEngine(device="cuda")`` with seeded random weights: requests
   of 16, 5 and 33 patches and one full-image render, counting GRU kernel
   launches (2 per chunk: one per BiGRU layer for both directions); hold
   the float32 output against the same engine on the CPU, run once in
   bfloat16, time img/s at batch 16 and profile one batch;
7. train v2 at full width with seeded weights through the weight bridge
   (BiGRU dropout 0.1 from a generator): 5 bf16 steps and 5 float32 steps
   (TF32 off) at batch 16, each run with the counts at 0 before it and read
   after (2 forward + 2 backward GRU launches per step: one of each per
   BiGRU layer for both directions), losses finite, the
   spectral u and BatchNorm running statistics moved; one float32 step at
   B=2 on the card against the CPU; bf16 img/s at batch 16 and 128; one
   profiled step per precision by kernel class; one eval step;
8. train through the epoch driver: print whether Pillow and cv2 import; v2
   at full width, bf16, batch 16, ``Trainer.fit`` over device-resident
   synthetic data (256 train samples, 32 val; plateau patience 0): one
   step run twice from one state, with cuDNN's default and its deterministic
   algorithms, tells whether the step is deterministic; with the
   deterministic ones, run A for 2 epochs, a new Trainer on its workdir
   restores A's state bit for bit and trains a third, and A must equal run
   B, 3 epochs uninterrupted (bit for bit, or within a limit set by the
   probe); B resumed for a fourth epoch with the default algorithms; the GRU
   launches of every ``fit`` (2 + 2 per train step, 2 forward per val
   batch), the record schema and both checkpoints;
   ``InferenceEngine.from_checkpoint`` against B's generator at its
   ``best_model`` save, bit for bit (2 GRU launches a chunk), and one full
   image; the train CLI for 1 epoch, again for 2 (it resumes), and the eval
   CLI; img/s per epoch and the epoch driver's cost per step, against
   phase 7 and against the epoch's steps run without the epoch driver just
   before and after it;
9. ``multi_step`` through CUDA graphs (``train/graphs.py``): the GRU
   forward and backward alone captured and replayed against eager
   launches; v2 at full width, bf16, batch 16, with
   ``cudnn.deterministic``: 8 steps from one saved state as eager steps
   and as 2 groups of 4 graph replays, bit for bit (G, D, BN statistics,
   u, both Adams, the summed metrics), and 4 val batches the same way;
   wall (host clock over 32 steps) against device (one profiled group) ms
   a step for K in {1, 4, 16}; ``Trainer.fit`` with multi_step=4 (run A, 2
   epochs, resumed with multi_step=1 for a third, against run B, 3 epochs,
   bit for bit), the GRU launches of every fit, one group's counts against
   the kernels in its profile, and the train CLI with ``--multi-step 4``;
10. oldv at full width (448x64, ``enc_chans=(32,64,128)``, a height-4 text
   map): serving in bf16 and f32 (img/s, 2 GRU launches a chunk, CUDA
   against CPU), 5 bf16 train steps (ms a step, 2 + 2 GRU launches), one
   f32 step CUDA against CPU at B=2 with phase 7's limits, a profiled bf16
   step by kernel class;
11. print the kernels' JSON line and, last, the device line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# bf16 tensor cores, HBM3.
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# GRU kernel vs plain: the product's sum order differs (per-lane k slices
# summed by warp shuffles vs cuBLAS), a few float32 ulps per step over 60
# steps.
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# GRU backward vs plain: dW_hh and db_hh sum over L*B rows (up to 7680) in
# another order; read 2.7e-5 on values up to 100 at B=128.
BACKWARD_ATOL, BACKWARD_RTOL = 1e-4, 1e-4
# conv3x3 vs F.conv2d: the probe's own rule, max |err| / max |ref|; bf16
# outputs of the same float32 sums differ by one bf16 step at most.
CONV_RULE = 5e-2
# CUDA vs CPU generator output, both float32 with TF32 off: cuDNN and the
# CPU take different algorithms and sum orders through ~20 conv layers
# (read 5.4e-7 on an H100); TF32 left on would miss this limit.
DEVICE_ATOL = 1e-4
# bfloat16 vs float32 output: bf16 keeps 8 bits of mantissa through every
# conv, so only a loose bound on the outputs in (0, 1) holds.
BF16_MAX_ABS, BF16_MEAN_ABS = 0.05, 0.01
# One float32 train step, CUDA vs CPU at B=2: losses to rtol 1e-4; BN
# running statistics and spectral u to atol 1e-5 + rtol 1e-4 (running
# variances reach ~10). G's Adam first moments (0.5 times the clipped
# gradient): per tensor, ||m_cuda - m_cpu|| <= 5e-2 ||m_cpu||. At full width
# the generator's gradient moves with sum order alone: every tensor differs
# by about 1% (L2) between the devices and by some 0.3% between one and
# eight CPU threads, which the run measures and prints beside it (the
# per-element limits of the tiny test miss by 40x here). The transposed
# conv's bias ahead of the bottleneck BatchNorm has a zero gradient in exact arithmetic: both devices
# hold rounding noise there, held to 1e-3 of the network's largest moment.
STEP_LOSS_RTOL, STEP_BUFFER_ATOL, STEP_BUFFER_RTOL = 1e-4, 1e-5, 1e-4
STEP_MOMENT_L2, STEP_MOMENT_ZERO = 5e-2, 1e-3
ZERO_GRADIENT_PARAMS = ("image_vae_decoder_module.bottleneck_proc.0.bias",)
# oldv's step moves D's u further apart: u is one power iteration on D's
# weights after their first Adam update, lr * g / (|g| + eps), which turns
# the devices' gradient differences where |g| is near eps into steps of up
# to lr = 1e-4 in either direction. On an H100 it read 1.46 of phase 7's
# limit (1.7e-5 on u near 0.2) against 0.84 for v2. Held to atol 1e-4 (lr).
OLDV_U_ATOL = 1e-4

L_TEXT = 60
BATCH = 16
TRAIN_STEPS = 5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call of ``fn``, for calls shorter than the host's
    time to enqueue them: a sleep kernel holds the stream while the host
    enqueues all ``iters`` calls, which then run back to back between the
    two events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9))     # cycles, ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gru_bound(length: int, batch: int, hidden: int):
    flops = 2 * length * batch * hidden * 3 * hidden
    nbytes = 4 * (length * batch * 3 * hidden + length * batch * hidden
                  + 3 * hidden * hidden + 3 * hidden)
    return bound(flops, nbytes, FP32_FLOPS)


def gru_backward_bound(length: int, batch: int, hidden: int,
                       directions: int = 1):
    """The backward's three products (gate pre-activations, the dh
    recurrence, dW_hh), each 2*L*B*H*3H flops in float32; bytes: x_proj,
    outs, their cotangent, W_hh and b_hh read, dx_proj, dW_hh, db_hh
    written; each per direction."""
    flops = 3 * 2 * length * batch * hidden * 3 * hidden
    nbytes = 4 * (2 * length * batch * 3 * hidden + 2 * length * batch
                  * hidden + 2 * (3 * hidden * hidden + 3 * hidden))
    return bound(directions * flops, directions * nbytes, FP32_FLOPS)


def conv_bound(n: int, h: int, w: int, c: int):
    flops = 2 * n * h * w * 9 * c * c
    nbytes = 2 * (2 * n * h * w * c + 9 * c * c)
    return bound(flops, nbytes, BF16_FLOPS)


def gru_inputs(gen, batch: int, hidden: int):
    scale = 1.0 / hidden ** 0.5
    x_proj = torch.randn(L_TEXT, batch, 3 * hidden, device="cuda",
                         generator=gen)
    w_hh = (torch.rand(3 * hidden, hidden, device="cuda",
                       generator=gen) * 2 - 1) * scale
    b_hh = (torch.rand(3 * hidden, device="cuda", generator=gen) * 2 - 1) \
        * scale
    return x_proj, w_hh, b_hh


def cudnn_gru(w_hh, b_hh, reverse_weights=None):
    """``torch.nn.GRU`` computing the recurrence on x_proj: an identity
    input projection makes its x @ W_ih^T + b_ih equal x_proj (one extra
    (3H x 3H) product per row). With ``reverse_weights`` (W_hh, b_hh of the
    right-to-left direction) it is bidirectional, both directions reading
    the same x_proj."""
    hidden = w_hh.shape[1]
    lib = torch.nn.GRU(3 * hidden, hidden,
                       bidirectional=reverse_weights is not None).cuda()
    directions = [("l0", (w_hh, b_hh))]
    if reverse_weights is not None:
        directions.append(("l0_reverse", reverse_weights))
    with torch.no_grad():
        for suffix, (w, b) in directions:
            getattr(lib, f"weight_ih_{suffix}").copy_(torch.eye(3 * hidden))
            getattr(lib, f"bias_ih_{suffix}").zero_()
            getattr(lib, f"weight_hh_{suffix}").copy_(w)
            getattr(lib, f"bias_hh_{suffix}").copy_(b)
    return lib


def phase_build(modules) -> dict:
    from vae_gan_mark_tpu_torch.ops.cuda_build import build_all

    t0 = time.perf_counter()
    built = build_all([m.source for m in modules])
    seconds = time.perf_counter() - t0
    print(f"[build] {len(built)} kernels in {seconds:.2f} s (one nvcc each, "
          f"in parallel)", flush=True)
    report = {}
    for source, (lib, log) in built.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "wgmma" in ln]
        report[source.name] = dict(library=os.path.relpath(lib, ROOT),
                                   ptxas=lines)
        for line in lines:
            print(f"[build] {source.name}: {line}", flush=True)
    return dict(seconds=seconds, kernels=report)


def phase_gru_forward(gru) -> dict:
    """Forward kernel vs plain at every shape: each direction alone (one
    launch each) and both directions of a layer in one launch; timings of
    the pair at H=256 for the batches 16 and 128; the pair's time per step
    at B=16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    clusters = {h: {rows: gru.KERNEL.max_active_clusters(h, rows)
                    for rows in (16, 32)} for h in (16, 256)}
    check(min(c for h in clusters.values() for c in h.values()) > 0,
          f"no cluster fits: {clusters}")
    print(f"[gru fwd] cudaOccupancyMaxActiveClusters (8 CTAs each) by "
          f"tile rows: {clusters}", flush=True)
    rows, per_step = [], None
    for hidden in (16, 256):
        for batch in (1, 16, 128):
            dirs = [gru_inputs(gen, batch, hidden) for _ in range(2)]
            refs = [gru.gru_recurrence_plain(*d, rev)
                    for d, rev in zip(dirs, (False, True))]
            single = [gru.gru_recurrence(*d, rev)
                      for d, rev in zip(dirs, (False, True))]
            before = gru.KERNEL.launches
            pair = gru.gru_bidirectional_forward(*dirs)
            torch.cuda.synchronize()
            pair_launches = gru.KERNEL.launches - before
            check(pair_launches == 1,
                  f"the bidirectional forward made {pair_launches} launches")
            errs = {}
            for name, got in (("single", single), ("pair", pair)):
                for rev, out, ref in zip((False, True), got, refs):
                    err = (out - ref).abs().max().item()
                    check(torch.allclose(out, ref, atol=KERNEL_ATOL,
                                         rtol=KERNEL_RTOL),
                          f"forward kernel ({name}) vs plain H={hidden} "
                          f"B={batch} reverse={rev}: max abs err {err}")
                    errs[f"{name}_{'reverse' if rev else 'forward'}"] = err
            row = dict(H=hidden, B=batch, errs=errs,
                       max_abs_err=max(errs.values()),
                       directions_per_launch=len(pair) / pair_launches,
                       plan=gru.KERNEL.plan(2, batch, hidden))
            if hidden == 256 and batch in (16, 128):
                row.update(time_gru_forward(gru, dirs))
            if hidden == 256 and batch == BATCH:
                per_step = gru_forward_per_step(gru, dirs)
            rows.append(row)
            timing = "".join(f" {k}={row[k]:.4f}" for k in (
                "ms", "single_ms", "plain_ms", "library_ms", "bound_ms")
                if k in row)
            print(f"[gru fwd] L={L_TEXT} H={hidden:3d} B={batch:3d} both "
                  f"directions: max abs err {row['max_abs_err']:.2e}{timing}"
                  f" tile_rows={row['plan']['tile_rows']} clusters="
                  f"{row['plan']['clusters']} waves={row['plan']['waves']}",
                  flush=True)
    return dict(rows=rows, per_step=per_step, max_active_clusters=clusters)


def time_gru_forward(gru, dirs) -> dict:
    """The pair at one shape, both directions on the first direction's
    x_proj as cuDNN's bidirectional ``nn.GRU`` takes them: the kernel, one
    direction, the plain pair, cuDNN, and the pair's bound."""
    (x_proj, w_f, b_f), (_, w_b, b_b) = dirs
    same = ((x_proj, w_f, b_f), (x_proj, w_b, b_b))
    length, batch, h3 = x_proj.shape
    hidden = h3 // 3
    ms = cuda_time_ms(lambda: gru.gru_bidirectional_forward(*same), 50)
    single_ms = cuda_time_ms(lambda: gru.gru_recurrence(
        x_proj, w_f, b_f, False), 50)
    plain_ms = cuda_time_ms(lambda: [gru.gru_recurrence_plain(*d, rev)
                                     for d, rev in zip(same, (False, True))],
                            3)
    lib = cudnn_gru(w_f, b_f, (w_b, b_b))
    with torch.no_grad():
        lib_out = lib(x_proj)[0]
        library_ms = cuda_time_ms(lambda: lib(x_proj), 50)
    pair = gru.gru_bidirectional_forward(*same)
    lib_err = max((lib_out[..., :hidden] - pair[0]).abs().max().item(),
                  (lib_out[..., hidden:] - pair[1]).abs().max().item())
    bound_ms, bound_by = gru_bound(length, batch, hidden)
    return dict(ms=ms, single_ms=single_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_max_abs_err=lib_err,
                bound_ms=2 * bound_ms, bound_by=bound_by)


def gru_forward_per_step(gru, dirs) -> dict:
    """The pair's device time over the first L steps of the same x_proj
    for L in {1, 15, 30, 60} (``device_time_ms``: at small L the host's
    time per call exceeds the kernel's); the least-squares line through the
    times gives the time per step (slope) and what a launch costs besides
    (intercept: the launch and the load of W_hh into registers)."""
    (x_f, w_f, b_f), (x_b, w_b, b_b) = dirs
    lengths = (1, 15, 30, 60)
    times = [device_time_ms(lambda: gru.gru_bidirectional_forward(
        (x_f[:n], w_f, b_f), (x_b[:n], w_b, b_b)), 50) for n in lengths]
    slope, intercept = np.polyfit(lengths, times, 1)
    result = dict(lengths=lengths, ms=times, us_per_step=slope * 1e3,
                  intercept_us=intercept * 1e3)
    print(f"[gru fwd] pair at H=256 B={BATCH}, L={list(lengths)}: ms "
          f"{[round(t, 4) for t in times]}; {result['us_per_step']:.3f} us "
          f"per step + {result['intercept_us']:.2f} us", flush=True)
    return result


def phase_gru_backward(gru) -> dict:
    """Backward kernel vs plain at every shape: each direction alone (one
    launch each) and both directions of a layer in one launch; timings of
    the pair at H=256 for the training batches 16 and 128."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    clusters = {h: gru.BACKWARD_KERNEL.max_active_clusters(h)
                for h in (16, 256)}
    check(min(clusters.values()) > 0, f"no cluster fits: {clusters}")
    print(f"[gru bwd] cudaOccupancyMaxActiveClusters (8 CTAs each): "
          f"{clusters}", flush=True)
    rows = []
    for hidden in (16, 256):
        for batch in (1, 16, 128):
            dirs = []
            for reverse in (False, True):
                x_proj, w_hh, b_hh = gru_inputs(gen, batch, hidden)
                outs = gru.gru_recurrence(x_proj, w_hh, b_hh, reverse)
                grad = torch.randn(outs.shape, device="cuda", generator=gen)
                dirs.append((x_proj, w_hh, b_hh, outs, grad))
            refs = [gru.gru_backward_plain(*d, rev)
                    for d, rev in zip(dirs, (False, True))]
            single = [gru.gru_recurrence_backward(*d, rev)
                      for d, rev in zip(dirs, (False, True))]
            before = gru.BACKWARD_KERNEL.launches
            pair = gru.gru_bidirectional_backward(*dirs)
            torch.cuda.synchronize()
            pair_launches = gru.BACKWARD_KERNEL.launches - before
            check(pair_launches == 1,
                  f"the bidirectional backward made {pair_launches} launches")
            errs = {}
            for name, got in (("single", single), ("pair", pair)):
                for rev, got_d, ref in zip((False, True), got, refs):
                    e = [(a - b).abs().max().item()
                         for a, b in zip(got_d, ref)]
                    ok = all(torch.allclose(a, b, atol=BACKWARD_ATOL,
                                            rtol=BACKWARD_RTOL)
                             for a, b in zip(got_d, ref))
                    check(ok, f"backward kernel ({name}) vs plain H={hidden}"
                              f" B={batch} reverse={rev}: max abs errs "
                              f"(dx, dW, db) {e}")
                    errs[f"{name}_{'reverse' if rev else 'forward'}"] = e
            row = dict(H=hidden, B=batch, errs=errs,
                       max_abs_err=max(max(e) for e in errs.values()),
                       directions_per_launch=len(pair) / pair_launches)
            if hidden == 256 and batch in (16, 128):
                row.update(time_gru_backward(gru, dirs))
                needed = 2 * -(-batch // 16)     # (direction, 16-row tile)
                row["waves"] = -(-needed // clusters[hidden])
            rows.append(row)
            timing = "".join(f" {k}={row[k]:.4f}" for k in (
                "ms", "kernel_ms", "single_ms", "fwd_bwd_ms", "plain_ms",
                "library_ms", "library_fwd_bwd_ms", "bound_ms") if k in row)
            print(f"[gru bwd] L={L_TEXT} H={hidden:3d} B={batch:3d} both "
                  f"directions: max abs err {row['max_abs_err']:.2e}"
                  f"{timing}" + (f" waves={row['waves']}"
                                 if "waves" in row else ""), flush=True)
    return dict(rows=rows, max_active_clusters=clusters)


def time_gru_backward(gru, dirs) -> dict:
    """The pair's backward at one shape: whole (kernel and its products),
    the kernel alone, forward + backward through the autograd function,
    one direction's whole backward, the plain backwards, and cuDNN's
    bidirectional ``nn.GRU`` backward alone and forward + backward."""
    (x_f, w_f, b_f, outs_f, grad_f), (x_b, w_b, b_b, outs_b, grad_b) = dirs
    length, batch, h3 = x_f.shape
    hidden = h3 // 3
    ms = cuda_time_ms(lambda: gru.gru_bidirectional_backward(*dirs), 50)
    single_ms = cuda_time_ms(lambda: gru.gru_recurrence_backward(
        *dirs[0], False), 50)
    prepared = [(x, torch.addmm(b, o.view(-1, hidden), w.t()).view(
        length, batch, h3), o, g, w, b, rev)
        for (x, w, b, o, g), rev in zip(dirs, (False, True))]
    kernel_ms = cuda_time_ms(lambda: gru.BACKWARD_KERNEL(prepared), 50)
    plain_ms = cuda_time_ms(lambda: [gru.gru_backward_plain(*d, rev) for d, rev
                                     in zip(dirs, (False, True))], 3)
    leaves = [t.clone().requires_grad_() for t in (x_f, w_f, b_f, x_b, w_b,
                                                    b_b)]

    def fwd_bwd():
        torch.autograd.backward(gru.bigru_recurrence_grad(*leaves),
                                [grad_f, grad_b])

    fwd_bwd_ms = cuda_time_ms(fwd_bwd, 30)
    lib = cudnn_gru(w_f, b_f, (w_b, b_b))
    lib_x = x_f.clone().requires_grad_()
    lib_params = list(lib.parameters())
    lib_grad = torch.cat([grad_f, grad_b], dim=-1)

    def lib_fwd_bwd():
        torch.autograd.grad(lib(lib_x)[0], [lib_x] + lib_params, lib_grad)

    library_fwd_bwd_ms = cuda_time_ms(lib_fwd_bwd, 30)
    lib_out = lib(lib_x)[0]
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, [lib_x] + lib_params, lib_grad, retain_graph=True), 30)
    bound_ms, bound_by = gru_backward_bound(length, batch, hidden, 2)
    return dict(ms=ms, kernel_ms=kernel_ms, single_ms=single_ms,
                plain_ms=plain_ms, fwd_bwd_ms=fwd_bwd_ms,
                library_ms=library_ms, library_fwd_bwd_ms=library_fwd_bwd_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def conv_inputs(gen, n, h, w, c):
    x = torch.randn(n, h, w, c, device="cuda", generator=gen).bfloat16()
    k = torch.randn(3, 3, c, c, device="cuda", generator=gen) / (3 * c ** 0.5)
    return x, k


def phase_conv(conv_probe) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = []
    shapes = [(h, w, c, f) for (h, w) in ((16, 32), (64, 448))
              for c, f in ((64, 2), (32, 4))] + [(64, 40, 64, 2)]
    for h, w, c, f in shapes:       # W=40: not a multiple of the tile
        x, k = conv_inputs(gen, 2, h, w, c)
        y = conv_probe.conv3x3_superp(x, k, f).float()
        torch.cuda.synchronize()
        ref = conv_probe.conv3x3_plain(x, k).float()
        abs_err = (y - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        check(err < CONV_RULE, f"conv3x3 vs F.conv2d (2,{h},{w}) C={c} "
                               f"f={f}: {err}")
        checks.append(dict(shape=[2, h, w, c], f=f, rel_err=err,
                           max_abs_err=abs_err))
        print(f"[conv] check (2,{h},{w}) C={c} f={f}: max|err|/max|ref| "
              f"= {err:.3e} (rule {CONV_RULE})", flush=True)

    # The probe's benchmark shapes are this kernel's own path: counts at 0
    # just before, read just after.
    inputs = {name: conv_inputs(gen, n, h, w, c)
              for name, (n, h, w, c, _) in conv_probe.PROBE_SHAPES.items()}
    conv_probe.KERNEL.launches = 0
    outs = {name: conv_probe.conv3x3_superp(
        *inputs[name], conv_probe.PROBE_SHAPES[name][4])
        for name in conv_probe.PROBE_SHAPES}
    torch.cuda.synchronize()
    launches = conv_probe.KERNEL.launches
    check(launches == len(conv_probe.PROBE_SHAPES),
          f"conv3x3 launches {launches} on the probe shapes")

    rows = {}
    for name, (n, h, w, c, f) in conv_probe.PROBE_SHAPES.items():
        x, k = inputs[name]
        kb = k.bfloat16()
        ref = conv_probe.conv3x3_plain(x, kb).float()
        err = ((outs[name].float() - ref).abs().max()
               / ref.abs().max()).item()
        check(err < CONV_RULE, f"conv3x3 at {name}: {err}")
        w_cl = kb.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x_nchw = x.permute(0, 3, 1, 2)            # channels-last strides
        ms = cuda_time_ms(lambda: conv_probe.conv3x3_superp(x, k, f), 10)
        plain_ms = cuda_time_ms(lambda: conv_probe.conv3x3_plain(x, kb), 5)
        library_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
            x_nchw, w_cl, padding=1), 20)
        bound_ms, bound_by = conv_bound(n, h, w, c)
        rows[name] = dict(shape=[n, h, w, c], f=f, rel_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          tflops=2 * n * h * w * 9 * c * c / ms / 1e9,
                          bound_share=bound_ms / ms,
                          vs_library=ms / library_ms)
        print(f"[conv] {name} {(n, h, w, c)}: err {err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} cudnn_bf16_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"{rows[name]['tflops']:.1f} TFLOP/s, bound/ms "
              f"{bound_ms / ms:.3f}, kernel/cuDNN {ms / library_ms:.3f}",
              flush=True)
    return dict(checks=checks, launches=launches, shapes=rows)


def make_requests(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ru = rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 1)) > 0.5
            ).astype(np.float32)
    texts = [f"SALE {i} -{10 + i}% ONLY TODAY" for i in range(n)]
    return ru, mask, texts


def check_patches(out: np.ndarray, n: int, cfg, what: str) -> None:
    check(out.shape == (n, cfg.patch_h, cfg.patch_w, 3),
          f"{what}: shape {out.shape}")
    check(bool(np.all(np.isfinite(out))), f"{what}: non-finite values")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
          f"{what}: values outside [0, 1]")


def phase_serve(gru, card: str) -> dict:
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.serve import InferenceEngine
    from vae_gan_mark_tpu_torch.utils.port_jax import (
        random_jax_tree, state_dict_from_jax)

    cfg = get_config("v2", compute_dtype="float32")
    t0 = time.perf_counter()
    params, stats = random_jax_tree(cfg, seed=0)
    state_dict = state_dict_from_jax(params, stats, cfg)
    engine = InferenceEngine(cfg, state_dict, batch_size=BATCH, seed=0,
                             device="cuda")
    print(f"[serve] v2 {cfg.patch_w}x{cfg.patch_h} engine ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    requests = {n: make_requests(cfg, n, seed=n) for n in (16, 5, 33)}
    img_rng = np.random.default_rng(7)
    image = img_rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    mask_image = np.zeros((720, 1280), np.uint8)
    quad = np.array([[300, 200], [900, 230], [890, 330], [290, 300]],
                    np.float32)

    # The serving path: counts start at 0 here and are read right after.
    gru.KERNEL.launches = 0
    outs = {n: engine.generate(*requests[n]) for n in (16, 5, 33)}
    rendered = engine.render(image, mask_image, quad, "NEW COLLECTION")
    torch.cuda.synchronize()
    launches = gru.KERNEL.launches
    chunks = sum(-(-n // BATCH) for n in (16, 5, 33)) + 1
    for n, out in outs.items():
        check_patches(out, n, cfg, f"generate({n})")
    check(rendered.shape == image.shape and
          bool(np.all(np.isfinite(rendered))), "render: bad output")
    check(launches == 2 * chunks,
          f"GRU kernel launches {launches}, expected 2 x {chunks} chunks")
    print(f"[serve] generate 16/5/33 + render: {chunks} chunks, "
          f"{launches} GRU kernel launches", flush=True)

    # Same engine on the CPU with the same seed, hence the same eps.
    cpu_engine = InferenceEngine(cfg, state_dict, batch_size=BATCH, seed=0,
                                 device="cpu")
    cpu_out = cpu_engine.generate(*requests[5])
    device_err = float(np.abs(cpu_out - outs[5]).max())
    check(device_err <= DEVICE_ATOL,
          f"CUDA vs CPU float32 max abs err {device_err} > {DEVICE_ATOL}")
    print(f"[serve] CUDA vs CPU float32 (TF32 off): max abs err "
          f"{device_err:.3e} (limit {DEVICE_ATOL})", flush=True)
    del cpu_engine

    bf16_cfg = get_config("v2", compute_dtype="bfloat16")
    bf16_engine = InferenceEngine(bf16_cfg, state_dict, batch_size=BATCH,
                                  seed=0, device="cuda")
    bf16_out = bf16_engine.generate(*requests[16])
    check_patches(bf16_out, 16, cfg, "bfloat16 generate(16)")
    diff = np.abs(bf16_out - outs[16])
    bf16_max, bf16_mean = float(diff.max()), float(diff.mean())
    check(bf16_max <= BF16_MAX_ABS and bf16_mean <= BF16_MEAN_ABS,
          f"bfloat16 vs float32: max {bf16_max}, mean {bf16_mean}")
    print(f"[serve] bfloat16 vs float32: max abs {bf16_max:.3e}, mean abs "
          f"{bf16_mean:.3e} (limits {BF16_MAX_ABS}, {BF16_MEAN_ABS})",
          flush=True)

    throughput, batch_ms = {}, {}
    engines = {"float32": engine, "bfloat16": bf16_engine}
    for name, eng in engines.items():
        ru, mask, texts = requests[16]
        eng.generate(ru, mask, texts)
        iters = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.generate(ru, mask, texts)   # returns host arrays: synced
        dt = time.perf_counter() - t0
        throughput[name] = iters * BATCH / dt
        batch_ms[name] = dt / iters * 1e3
        print(f"[serve] {name} generate bs={BATCH}: "
              f"{throughput[name]:.1f} img/s ({dt / iters * 1e3:.2f} ms "
              f"per batch) on {card}", flush=True)

    profile = {name: profile_call(
        lambda eng=eng: eng.generate(*requests[16]), f"{name} generate(16)",
        batch_ms[name]) for name, eng in engines.items()}
    return dict(launches=launches, chunks=chunks, device_max_abs_err=device_err,
                bf16_max_abs=bf16_max, bf16_mean_abs=bf16_mean,
                img_per_s=throughput, profile=profile)


def train_batch(cfg, n: int, seed: int, device, with_eps: bool = False):
    from vae_gan_mark_tpu_torch.train import batch_to_device

    rng = np.random.default_rng(seed)
    shape = (n, cfg.patch_h, cfg.patch_w)
    tokens = rng.integers(1, cfg.vocab_size, (n, cfg.max_text_len))
    tokens[:, rng.integers(10, cfg.max_text_len):] = 0        # PAD tail
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                 np.float32),
             "text": tokens}
    if with_eps:
        batch["eps"] = rng.normal(0, 1, (n, 1, 1, cfg.z_ch)).astype(
            np.float32)
    return batch_to_device(batch, device)


def train_weights(cfg):
    from vae_gan_mark_tpu_torch.utils.port_jax import (
        discriminator_state_dict_from_jax, random_discriminator_tree,
        random_jax_tree, random_vgg_tree, state_dict_from_jax,
        vgg_state_dict_from_jax)

    return (state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg),
            discriminator_state_dict_from_jax(*random_discriminator_tree(1)),
            vgg_state_dict_from_jax(random_vgg_tree(2)))


def make_trainer(cfg, weights, device):
    from vae_gan_mark_tpu_torch.models import VGG16Features
    from vae_gan_mark_tpu_torch.ops.precision import torch_dtype
    from vae_gan_mark_tpu_torch.train import create_train_state

    g_sd, d_sd, vgg_sd = weights
    state = create_train_state(cfg, g_sd, d_sd, device=device)
    vgg = VGG16Features(torch_dtype(cfg.compute_dtype))
    vgg.load_state_dict(vgg_sd)
    return state, vgg.to(device)


def watched_buffers(state) -> dict:
    return {k: v.detach().clone() for k, v in
            {**state.generator.state_dict(),
             **state.discriminator.state_dict()}.items()
            if "running_" in k or "weight_u" in k}


def run_train_path(gru, cfg, weights, name: str) -> dict:
    """TRAIN_STEPS steps at batch 16 with the GRU counts at 0 just before
    and read just after."""
    from vae_gan_mark_tpu_torch.train import build_train_step

    state, vgg = make_trainer(cfg, weights, "cuda")
    step = build_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [train_batch(cfg, BATCH, 100 + i, "cuda")
               for i in range(TRAIN_STEPS)]
    before = watched_buffers(state)
    torch.cuda.synchronize()
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    t0 = time.perf_counter()
    history = []
    for batch in batches:
        state, metrics = step(state, vgg, batch, gen, 1e-3)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(forward=gru.KERNEL.launches,
                    backward=gru.BACKWARD_KERNEL.launches)
    check(launches == dict(forward=2 * TRAIN_STEPS,
                           backward=2 * TRAIN_STEPS),
          f"{name} train: GRU launches {launches}, expected 2 + 2 per step "
          f"over {TRAIN_STEPS} steps")
    history = [{k: float(v) for k, v in m.items()} for m in history]
    check(all(np.isfinite(v) for m in history for v in m.values()),
          f"{name} train: non-finite losses {history}")
    after = watched_buffers(state)
    moved = {kind: any(not torch.equal(before[k], after[k])
                       for k in before if kind in k)
             for kind in ("running_mean", "running_var", "weight_u")}
    check(all(moved.values()), f"{name} train: buffers did not move {moved}")
    print(f"[train] {name} {TRAIN_STEPS} steps bs={BATCH}: {seconds:.2f} s "
          f"(first step included), GRU launches {launches}, last losses "
          + " ".join(f"{k}={v:.4f}" for k, v in history[-1].items()),
          flush=True)
    return dict(state=state, vgg=vgg, step=step, gen=gen,
                result=dict(launches=launches, losses=history,
                            seconds=seconds, buffers_moved=moved))


def step_rate(step, state, vgg, gen, batch, iters: int) -> dict:
    n = batch["ru"].shape[0]
    for _ in range(2):
        step(state, vgg, batch, gen, 1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, vgg, batch, gen, 1e-3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(batch=n, step_ms=dt / iters * 1e3, img_per_s=iters * n / dt)


def l2_spread(a: dict, b: dict) -> list:
    """Per-tensor ||a - b|| / ||b|| over the moments, sorted, largest
    last; the zero-gradient parameters left out."""
    return sorted(((a[k] - b[k]).norm().item()
                   / max(b[k].norm().item(), 1e-30), k)
                  for k in b if k not in ZERO_GRADIENT_PARAMS)


def compare_devices(cfg, weights, one_thread: bool = True,
                    u_atol: float = STEP_BUFFER_ATOL) -> dict:
    """One float32 step at B=2, dropout 0, same weights, batch and eps, on
    the card and on the CPU; with ``one_thread`` the CPU step once more on
    one thread, whose spread against the CPU's default threads is sum order
    alone. D's spectral u is held to ``u_atol`` + STEP_BUFFER_RTOL, the
    BatchNorm statistics to phase 7's limit; both readings are printed
    against phase 7's limit."""
    import dataclasses

    from vae_gan_mark_tpu_torch.train import build_train_step

    cfg = dataclasses.replace(cfg, char_rnn_dropout=0.0)
    threads = torch.get_num_threads()
    runs = {}
    runs_on = [("cuda", threads), ("cpu", threads)]
    if one_thread:
        runs_on.append(("cpu_1_thread", 1))
    for device, n_threads in runs_on:
        torch.set_num_threads(n_threads)
        dev = device.split("_")[0]
        state, vgg = make_trainer(cfg, weights, dev)
        batch = train_batch(cfg, 2, 7, dev, with_eps=True)
        state, metrics = build_train_step(cfg)(
            state, vgg, batch, torch.Generator(device=dev).manual_seed(0),
            1e-3)
        runs[device] = (
            {k: float(v) for k, v in metrics.items()},
            {k: v.cpu() for k, v in watched_buffers(state).items()},
            {n: state.opt_g.state[p]["exp_avg"].cpu()
             for n, p in state.generator.named_parameters()})
    torch.set_num_threads(threads)
    (m_gpu, b_gpu, mom_gpu), (m_cpu, b_cpu, mom_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                   for k in m_cpu)
    # Buffers: |err| <= atol + rtol * |cpu|, read as a share of that limit.
    def share(keys, atol=STEP_BUFFER_ATOL):
        return max(((b_gpu[k] - b_cpu[k]).abs()
                    / (atol + STEP_BUFFER_RTOL * b_cpu[k].abs())).max().item()
                   for k in keys)

    u_keys = [k for k in b_cpu if "weight_u" in k]
    bn_err = share([k for k in b_cpu if k not in u_keys])
    u_err = share(u_keys)
    buffer_err = max(bn_err, u_err)
    net_max = max(v.abs().max().item() for v in mom_cpu.values())
    zero_err = max((mom_gpu[k] - mom_cpu[k]).abs().max().item()
                   / (STEP_MOMENT_ZERO * net_max) for k in ZERO_GRADIENT_PARAMS)
    devices = l2_spread(mom_gpu, mom_cpu)
    cpu_threads = (l2_spread(runs["cpu_1_thread"][2], mom_cpu)
                   if one_thread else [(float("nan"), "not run")])
    moment_err = max(devices[-1][0] / STEP_MOMENT_L2, zero_err)
    result = dict(losses_cuda=m_gpu, losses_cpu=m_cpu,
                  loss_max_rel_err=loss_err,
                  buffer_err_over_limit=buffer_err,
                  bn_err_over_limit=bn_err, u_err_over_limit=u_err,
                  u_atol=u_atol,
                  moment_err_over_limit=moment_err,
                  moment_l2_median=devices[len(devices) // 2][0],
                  worst_moments=devices[-3:],
                  cpu_threads=threads,
                  cpu_1_thread_l2_median=cpu_threads[len(cpu_threads) // 2][0],
                  cpu_1_thread_worst=cpu_threads[-3:],
                  zero_gradient_err_over_limit=zero_err,
                  largest_moment=net_max)
    print(f"[train] CUDA vs CPU float32 step at B=2: losses max rel err "
          f"{loss_err:.2e} (limit {STEP_LOSS_RTOL}), BN statistics at "
          f"{bn_err:.3f} and D's u at {u_err:.3f} of phase 7's limit"
          + (f" (u held to atol {u_atol:.0e}: {share(u_keys, u_atol):.3f})"
             if u_atol != STEP_BUFFER_ATOL else "")
          + f"; G's Adam moments per tensor "
          f"L2 median {result['moment_l2_median']:.2e}, worst "
          f"{devices[-1][0]:.2e} ({devices[-1][1]}; limit {STEP_MOMENT_L2});"
          f" CPU 1 vs {threads} threads: median "
          f"{result['cpu_1_thread_l2_median']:.2e}, worst "
          f"{cpu_threads[-1][0]:.2e}; zero-gradient bias at {zero_err:.3f} "
          f"of its limit", flush=True)
    check(loss_err <= STEP_LOSS_RTOL and bn_err <= 1.0
          and share(u_keys, u_atol) <= 1.0 and moment_err <= 1.0,
          f"CUDA vs CPU train step: {result}")
    return result


def phase_train(gru, card: str) -> dict:
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.train import build_eval_step

    cfgs = {name: get_config("v2", compute_dtype=name)
            for name in ("bfloat16", "float32")}
    t0 = time.perf_counter()
    weights = train_weights(cfgs["float32"])
    print(f"[train] seeded G, D and VGG weights through the bridge in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    result, runs = {}, {}
    for name, cfg in cfgs.items():
        runs[name] = run_train_path(gru, cfg, weights, name)
        result[name] = runs[name]["result"]

    rates = {}
    for name in cfgs:
        run = runs[name]
        batches = (BATCH, 128) if name == "bfloat16" else (BATCH,)
        rates[name] = {}
        for n in batches:
            batch = train_batch(cfgs[name], n, 200 + n, "cuda")
            rates[name][n] = step_rate(run["step"], run["state"], run["vgg"],
                                       run["gen"], batch,
                                       10 if n == BATCH else 5)
            r = rates[name][n]
            print(f"[train] {name} step bs={n}: {r['img_per_s']:.1f} img/s "
                  f"({r['step_ms']:.1f} ms per step) on {card}", flush=True)
            del batch
        torch.cuda.empty_cache()
    result["rates"] = rates

    result["profile"] = {}
    for name in cfgs:
        run = runs[name]
        batch = train_batch(cfgs[name], BATCH, 300, "cuda")
        result["profile"][name] = profile_call(
            lambda run=run, batch=batch: (run["step"](
                run["state"], run["vgg"], batch, run["gen"], 1e-3),
                torch.cuda.synchronize()),
            f"{name} train step bs={BATCH}",
            rates[name][BATCH]["step_ms"])

    run = runs["bfloat16"]
    metrics, fake = build_eval_step(cfgs["bfloat16"])(
        run["state"], run["vgg"], train_batch(cfgs["bfloat16"], BATCH, 400,
                                              "cuda"), run["gen"], 1e-3)
    metrics = {k: float(v) for k, v in metrics.items()}
    check(set(metrics) == {"recon", "kl", "psnr", "masked_l1",
                           "mark_recovery", "gan_g", "perc", "loss_G",
                           "loss_D"}
          and all(np.isfinite(v) for v in metrics.values())
          and tuple(fake.shape) == (BATCH, 64, 448, 3),
          f"eval step: {metrics}")
    print("[train] eval step bf16: " + " ".join(
        f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)
    result["eval"] = metrics
    del runs
    torch.cuda.empty_cache()
    result["cuda_vs_cpu"] = compare_devices(cfgs["float32"], weights)
    return result


DRIVER_TRAIN_SAMPLES, DRIVER_VAL_SAMPLES = 256, 32   # 16 steps, 2 val batches
# The record keys of a full-loss config (vae_gan_mark_tpu_torch/train/loop.py,
# the JAX package's schema), besides the logger's own "step" and "time".
RECORD_KEYS = {
    "epoch", "train/generator_loss", "train/discriminator_loss",
    "train/recon_loss", "train/kl_loss", "train/gan_loss_g",
    "train/perceptual_loss", "train/images_per_sec",
    "train_params/current_kl_weight", "learning_rate/generator",
    "learning_rate/discriminator", "val/recon_loss", "val/psnr",
    "val/masked_l1", "val/mark_recovery", "val/generator_loss",
    "val/discriminator_loss", "val/kl_loss", "val/kl_loss_raw",
    "val/kl_loss_weighted", "val/gan_loss_g", "val/perceptual_loss"}
UNTIMED = ("step", "time", "train/images_per_sec")
# Run A (2 epochs, then resumed for a third) against run B (3 epochs), both
# with cudnn.deterministic: equal bit for bit when one bf16 step run twice
# from one state in that mode gives the same state. Otherwise the largest
# difference d1 of that probe sets the limits: parameters within
# DRIVER_PARAM_FACTOR * d1 per step run (48), and each value of the epoch-3
# record within DRIVER_RECORD_RTOL.
DRIVER_PARAM_FACTOR = 4.0
DRIVER_RECORD_RTOL = 1e-2
# Scratch workdirs of the phase, git-ignored and removed at its end: a
# full-width checkpoint is about 0.95 GB, too large for OUT_DIR.
RUNS_DIR = os.path.join(ROOT, "chip_smoke_runs")


def state_tensors(state) -> dict:
    """Every tensor of a train state: G's and D's parameters and buffers
    (BatchNorm statistics, spectral u) and both Adams' moments and steps."""
    out = {f"G.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"D.{k}": v
                for k, v in state.discriminator.state_dict().items()})
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, entry in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v for k, v in entry.items()})
    return out


def max_abs_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in b)


def read_records(workdir: str) -> list:
    with open(os.path.join(workdir, "v2.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_cli(module: str, *args: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m {module} {' '.join(args)} exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    print(f"[trainer] python -m {module} {' '.join(args)}: exit 0 in "
          f"{seconds:.1f} s", flush=True)
    return proc.stdout


def phase_epoch_driver(gru, card: str, rates: dict) -> dict:
    """v2 at full width, bf16, batch 16, through ``Trainer.fit`` over
    device-resident synthetic data: run A (2 epochs), its resume (restored
    state against A's, bit for bit; then a third epoch), run B (3 epochs
    uninterrupted), A against B, the GRU launches of every fit, the record
    schema, ``from_checkpoint`` against B's generator at its best save, and
    the train and eval CLIs."""
    import copy
    import importlib
    import shutil

    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.serve import InferenceEngine
    from vae_gan_mark_tpu_torch.train.loop import Trainer, make_generator
    from vae_gan_mark_tpu_torch.train.schedule import kl_weight_for_epoch
    from vae_gan_mark_tpu_torch.train.state import get_lr

    have = {}
    for module in ("PIL", "cv2"):
        try:
            importlib.import_module(module)
            have[module] = True
        except ImportError:
            have[module] = False
    print(f"[trainer] Pillow importable: {have['PIL']}; cv2 importable: "
          f"{have['cv2']}", flush=True)
    if not have["PIL"]:
        print("[trainer] no Pillow: the synthetic datasets are built with "
              "text_dependent=False (no glyphs drawn)", flush=True)
        print("[trainer] no Pillow: serving runs through engine.render on "
              "numpy arrays in this process (it does so in any case)",
              flush=True)

    cfg = get_config("v2", compute_dtype="bfloat16", batch_size=BATCH,
                     **{"scheduler.patience": 0})
    steps = DRIVER_TRAIN_SAMPLES // BATCH
    val_batches = DRIVER_VAL_SAMPLES // BATCH
    t0 = time.perf_counter()
    train_ds = SyntheticPatchDataset(cfg, DRIVER_TRAIN_SAMPLES, seed=0,
                                     text_dependent=have["PIL"])
    val_ds = SyntheticPatchDataset(cfg, DRIVER_VAL_SAMPLES, seed=1,
                                   text_dependent=have["PIL"])
    train_data = DeviceResidentSynthetic(train_ds, BATCH, steps)
    val_data = DeviceResidentSynthetic(val_ds, BATCH, val_batches,
                                       advance_per_epoch=False)
    print(f"[trainer] datasets: {train_data.nbytes() / 1e6:.0f} MB train + "
          f"{val_data.nbytes() / 1e6:.0f} MB val on the card, built in "
          f"{time.perf_counter() - t0:.1f} s; {steps} steps and "
          f"{val_batches} val batches an epoch", flush=True)

    class TimedTrainer(Trainer):
        """Times each epoch's parts and keeps G as it was at each
        ``best_model`` save."""

        def __init__(self, *args, **kwargs):
            self.timings, self.best_generator = {}, None
            super().__init__(*args, **kwargs)

        def _timed(self, epoch, part, fn, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            row = self.timings.setdefault(epoch + 1, {})
            row[part] = row.get(part, 0.0) + time.perf_counter() - t
            return out

        def train_epoch(self, epoch):
            return self._timed(epoch, "train_s", super().train_epoch, epoch)

        def validate(self, epoch):
            return self._timed(epoch, "val_s", super().validate, epoch)

        def _save(self, name, epoch):
            if name == "best_model":
                self.best_generator = {
                    k: v.detach().clone()
                    for k, v in self.state.generator.state_dict().items()}
            return self._timed(epoch, "save_s", super()._save, name, epoch)

    def fit(trainer, epochs: int, what: str) -> dict:
        runs = epochs - trainer.epoch
        torch.cuda.synchronize()
        gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
        t = time.perf_counter()
        trainer.fit(epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(forward=gru.KERNEL.launches,
                        backward=gru.BACKWARD_KERNEL.launches)
        expected = dict(forward=runs * (2 * steps + 2 * val_batches),
                        backward=runs * 2 * steps)
        check(launches == expected,
              f"{what}: GRU launches {launches}, expected {expected} (2 + 2 "
              f"per train step, 2 forward per val batch)")
        records = read_records(trainer.workdir)[-runs:]
        for rec in records:
            ep = int(rec["epoch"])
            tm = trainer.timings[ep]
            wall = sum(tm.values())
            print(f"[trainer] {what} epoch {ep}: "
                  f"train/images_per_sec {rec['train/images_per_sec']:.1f}, "
                  f"wall {wall:.2f} s (train {tm['train_s']:.2f}, val "
                  f"{tm['val_s']:.2f}, saves {tm.get('save_s', 0.0):.2f}); "
                  + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                             if k.startswith("val/")), flush=True)
        print(f"[trainer] {what}: fit({epochs}) in {seconds:.1f} s, GRU "
              f"launches {launches}", flush=True)
        return dict(seconds=seconds, launches=launches, records=records,
                    timings=trainer.timings)

    def step_twice(trainer, batch, kl_w: float) -> float:
        """The largest difference in G and D after one train step run twice
        from the trainer's state."""
        after = []
        for _ in range(2):
            probe = copy.deepcopy(trainer.state)
            trainer.train_step(probe, trainer.vgg, batch, make_generator(
                trainer.device, trainer.seed, probe.step), kl_w)
            after.append({k: v.detach().clone() for k, v in
                          state_tensors(probe).items()
                          if not k.startswith("opt_")})
            del probe
        diff = max_abs_diff(*after)
        del after
        torch.cuda.empty_cache()
        return diff

    def bare_step_ms(trainer, epoch: int) -> float:
        """ms a step of the epoch's train steps on a copy of the trainer's
        state, without the epoch driver: the batches gathered first, one
        synchronize at the end, no prefetch thread and no metric sums."""
        state = copy.deepcopy(trainer.state)
        batches = list(train_data(epoch))
        kl_w = float(np.float32(kl_weight_for_epoch(cfg, epoch)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for batch in batches:
            trainer.train_step(state, trainer.vgg, batch, make_generator(
                trainer.device, trainer.seed, state.step), kl_w)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        del state, batches
        torch.cuda.empty_cache()
        return seconds / steps * 1e3

    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    wd_a, wd_b = (os.path.join(RUNS_DIR, n) for n in ("run_a", "run_b"))
    result = dict(have=have)
    try:
        run_a = TimedTrainer(cfg, train_data, val_data, wd_a, seed=0)
        # Is the bf16 step deterministic? One step twice from A's init,
        # with cuDNN's default algorithms and with its deterministic ones.
        batch = run_a._put(next(iter(train_data(0))))
        kl_w = float(np.float32(kl_weight_for_epoch(cfg, 0)))
        d1 = {}
        for mode in ("default", "deterministic"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            d1[mode] = step_twice(run_a, batch, kl_w)
        del batch
        print(f"[trainer] one bf16 train step run twice from one state: "
              f"largest difference in G and D {d1['default']:.3e} with "
              f"cuDNN's default algorithms, {d1['deterministic']:.3e} with "
              f"cudnn.deterministic, which runs A and B use", flush=True)
        result["step_twice_max_abs_diff"] = d1

        # Run A, then a new Trainer on its workdir.
        result["run_a"] = fit(run_a, 2, "run A")
        a_end = {k: v.detach().clone()
                 for k, v in state_tensors(run_a.state).items()}
        a_host = dict(epoch=1, best_val=run_a.best_val,
                      sched_g=copy.copy(run_a.sched_g),
                      sched_d=copy.copy(run_a.sched_d),
                      lr_g=get_lr(run_a.state.opt_g),
                      lr_d=get_lr(run_a.state.opt_d),
                      step=run_a.state.step)
        del run_a
        torch.cuda.empty_cache()

        resumed = TimedTrainer(cfg, train_data, val_data, wd_a, seed=0)
        got = state_tensors(resumed.state)
        check(set(got) == set(a_end), "resume: the restored state has other "
                                      "tensors than run A's")
        differ = [k for k in a_end if not torch.equal(got[k], a_end[k])]
        got_host = dict(epoch=resumed.epoch - 1, best_val=resumed.best_val,
                        sched_g=resumed.sched_g, sched_d=resumed.sched_d,
                        lr_g=get_lr(resumed.state.opt_g),
                        lr_d=get_lr(resumed.state.opt_d),
                        step=resumed.state.step)
        check(not differ and got_host == a_host,
              f"resume: restored state differs from run A's end: tensors "
              f"{differ[:5]}, host {got_host} vs {a_host}")
        print(f"[trainer] resume: {len(a_end)} tensors (G, D, BN statistics, "
              f"u, both Adams) and {sorted(a_host)} equal run A's end, bit "
              f"for bit", flush=True)
        del a_end

        result["resumed"] = fit(resumed, 3, "run A resumed")
        a_final = {k: v.detach().clone() for k, v in
                   state_tensors(resumed.state).items()
                   if not k.startswith("opt_")}
        del resumed
        torch.cuda.empty_cache()

        run_b = TimedTrainer(cfg, train_data, val_data, wd_b, seed=0)
        result["run_b"] = fit(run_b, 3, "run B")
        b_final = {k: v for k, v in state_tensors(run_b.state).items()
                   if not k.startswith("opt_")}
        rec_b3 = read_records(wd_b)[-1]

        # A against B.
        param_diff = max_abs_diff(a_final, b_final)
        rec_a3 = read_records(wd_a)[-1]
        check(set(rec_a3) == set(rec_b3), "A and B records differ in keys")
        rec_rel = max(abs(rec_a3[k] - rec_b3[k]) / max(abs(rec_b3[k]), 1e-12)
                      for k in rec_b3 if k not in UNTIMED)
        if d1["deterministic"] == 0:
            limits = dict(params=0.0, record_rtol=0.0)
        else:
            limits = dict(params=DRIVER_PARAM_FACTOR * d1["deterministic"]
                          * 3 * steps, record_rtol=DRIVER_RECORD_RTOL)
        print(f"[trainer] A (2 epochs + resume) against B (3 epochs): "
              f"parameters and buffers differ by {param_diff:.3e} (limit "
              f"{limits['params']:.3e}), the epoch-3 records by "
              f"{rec_rel:.3e} relative (limit {limits['record_rtol']:.1e})",
              flush=True)
        check(param_diff <= limits["params"]
              and rec_rel <= limits["record_rtol"],
              f"A against B: params {param_diff} records {rec_rel}, limits "
              f"{limits}")
        result["a_vs_b"] = dict(param_max_abs_diff=param_diff,
                                record_max_rel_diff=rec_rel, limits=limits)
        del a_final, b_final

        # The schema and the checkpoints.
        for rec in read_records(wd_b):
            check(set(rec) - {"step", "time"} == RECORD_KEYS,
                  f"record keys {sorted(set(rec) ^ RECORD_KEYS)}")
        for name in ("last_checkpoint", "best_model"):
            check(os.path.isfile(os.path.join(wd_b, name, "state.pt")),
                  f"run B has no {name}")
        with open(os.path.join(wd_b, "best_model", "host_meta.json")) as f:
            best_epoch = json.load(f)["epoch"]
        print(f"[trainer] run B's records have the {len(RECORD_KEYS)} keys of "
              f"the schema; last_checkpoint/ and best_model/ (epoch "
              f"{best_epoch + 1}) exist", flush=True)

        # Serving from B's best checkpoint.
        engine = InferenceEngine.from_checkpoint(cfg, wd_b, "best_model",
                                                 batch_size=BATCH, seed=0)
        reference = InferenceEngine(cfg, run_b.best_generator,
                                    batch_size=BATCH, seed=0)
        requests = make_requests(cfg, BATCH, seed=21)
        torch.cuda.synchronize()
        gru.KERNEL.launches = 0
        patches = engine.generate(*requests)
        torch.cuda.synchronize()
        serve_launches = gru.KERNEL.launches
        check(serve_launches == 2, f"from_checkpoint generate(16): "
                                   f"{serve_launches} GRU launches, expected 2")
        check_patches(patches, BATCH, cfg, "from_checkpoint generate(16)")
        same = np.array_equal(patches, reference.generate(*requests))
        check(same, "from_checkpoint patches differ from the generator B "
                    "held at its best_model save")
        img_rng = np.random.default_rng(8)
        image = img_rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        quad = np.array([[100, 120], [500, 140], [495, 230], [95, 210]],
                        np.float32)
        rendered = engine.render(image, np.zeros((480, 640), np.uint8), quad,
                                 "FROM CHECKPOINT")
        check(rendered.shape == image.shape
              and bool(np.all(np.isfinite(rendered))), "render: bad output")
        print(f"[trainer] from_checkpoint(best_model) generate(16): equal to "
              f"the in-memory generator bit for bit, {serve_launches} GRU "
              f"launches; one full image rendered", flush=True)
        result["serve"] = dict(launches=serve_launches, equal=same)
        det_train_s = run_b.timings[3]["train_s"]
        del engine, reference, run_b
        torch.cuda.empty_cache()

        # B resumed for a fourth epoch with cuDNN's default algorithms, as
        # the CLI trains: the Trainer's rate against phase 7's bare step,
        # and against the same epoch's steps without the epoch driver (its
        # batches gathered first, no prefetch thread, no metric sums) on a
        # copy of the state, timed just before and just after the epoch.
        torch.backends.cudnn.deterministic = False
        run_b4 = TimedTrainer(cfg, train_data, val_data, wd_b, seed=0)
        bare_ms = [bare_step_ms(run_b4, 3)]
        result["run_b_default"] = fit(run_b4, 4, "run B resumed, cuDNN "
                                                 "default")
        bare_ms.append(bare_step_ms(run_b4, 3))
        rate = rates["bfloat16"][BATCH]
        records_b = read_records(wd_b)
        driver = {}
        for ep, mode, train_s in ((3, "deterministic", det_train_s),
                                  (4, "default",
                                   run_b4.timings[4]["train_s"])):
            driver[mode] = dict(
                epoch=ep, per_step_ms=train_s / steps * 1e3,
                img_per_s=records_b[ep - 1]["train/images_per_sec"])
            print(f"[trainer] run B epoch {ep} (cuDNN {mode}): "
                  f"{driver[mode]['img_per_s']:.1f} img/s through "
                  f"Trainer.fit, {driver[mode]['per_step_ms']:.2f} ms a step "
                  f"(the epoch's train time over its {steps} steps)",
                  flush=True)
        driver_ms = driver["default"]["per_step_ms"] - rate["step_ms"]
        print(f"[trainer] phase 7's bare bf16 bs={BATCH} step (cuDNN "
              f"default): {rate['img_per_s']:.1f} img/s, "
              f"{rate['step_ms']:.2f} ms a step; so the epoch driver costs "
              f"{driver_ms:.2f} ms a step on {card}", flush=True)
        bracket_ms = (driver["default"]["per_step_ms"]
                      - sum(bare_ms) / len(bare_ms))
        print(f"[trainer] the epoch's {steps} steps without the epoch "
              f"driver, just before and just after it: {bare_ms[0]:.2f} and "
              f"{bare_ms[1]:.2f} ms a step; so the epoch driver costs "
              f"{bracket_ms:.2f} ms a step", flush=True)
        result["driver"] = dict(driver, phase7_step_ms=rate["step_ms"],
                                phase7_img_per_s=rate["img_per_s"],
                                driver_ms_per_step=driver_ms,
                                bare_ms_per_step=bare_ms,
                                driver_ms_per_step_bracketed=bracket_ms)
        del run_b4
        torch.cuda.empty_cache()

        # The CLIs, as a user runs them.
        if not have["PIL"]:
            check(False, "the train CLI's synthetic data needs Pillow")
        cli_dir = os.path.join(RUNS_DIR, "cli_run")
        train_args = ("--variant", "v2", "--synthetic", "--synthetic-samples",
                      "64", "--batch-size", "16")
        run_cli("vae_gan_mark_tpu_torch.train", *train_args, "--epochs", "1",
                "--workdir", cli_dir)
        for name in ("last_checkpoint", "best_model"):
            check(os.path.isfile(os.path.join(cli_dir, name, "state.pt")),
                  f"the train CLI wrote no {name}")
        out = run_cli("vae_gan_mark_tpu_torch.train", *train_args,
                      "--epochs", "2", "--workdir", cli_dir)
        check("[resume] from epoch 0" in out,
              f"the second train CLI run did not resume: {out[-500:]}")
        out = run_cli("vae_gan_mark_tpu_torch.eval", "--synthetic",
                      "--workdir", cli_dir)
        lines = out.strip().splitlines()
        metrics = json.loads(lines[-1])
        check(len(lines) == 1 and all(np.isfinite(v)
                                      for v in metrics.values()),
              f"eval CLI output: {out[-500:]}")
        print(f"[trainer] eval CLI: {lines[-1]}", flush=True)
        result["cli"] = dict(eval=metrics)

        keep = os.path.join(OUT_DIR, "epoch_driver")
        os.makedirs(keep, exist_ok=True)
        for name, wd in (("run_a", wd_a), ("run_b", wd_b),
                         ("cli_run", cli_dir)):
            shutil.copy(os.path.join(wd, "v2.metrics.jsonl"),
                        os.path.join(keep, f"{name}.metrics.jsonl"))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return result


# Phase 9: multi_step through CUDA graphs. v2 at full width, bf16, bs 16.
MULTI_K = 4
# Wall time of the step by the host clock over this many steps for each K.
TIMED_STEPS = 32


def group_state_tensors(state) -> dict:
    return {k: v.detach().clone() for k, v in state_tensors(state).items()}


def phase_graph_probe(gru) -> dict:
    """The GRU forward and backward alone, captured in one CUDA graph at
    L=60, B=16, H=256 (both directions of a layer, 8-CTA clusters launched
    with ``cudaLaunchKernelEx``): replays on new inputs against eager
    launches, bit for bit."""
    from vae_gan_mark_tpu_torch.train.graphs import CapturedStep

    gen = torch.Generator(device="cuda").manual_seed(5)
    params = [t.requires_grad_() for t in (*gru_inputs(gen, BATCH, 256)[1:],
                                           *gru_inputs(gen, BATCH, 256)[1:])]

    def inputs(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return {"ru": torch.randn(L_TEXT, BATCH, 768, device="cuda",
                                  generator=g),
                "en": torch.randn(L_TEXT, BATCH, 768, device="cuda",
                                  generator=g),
                "mask": torch.randn(L_TEXT, BATCH, 512, device="cuda",
                                    generator=g)}

    def fwd_bwd(batch, generator=None, kl=None):
        x_f = batch["ru"].clone().requires_grad_()
        x_b = batch["en"].clone().requires_grad_()
        outs = gru.bigru_recurrence_grad(x_f, params[0], params[1], x_b,
                                         params[2], params[3])
        grads = torch.autograd.grad(
            outs, [x_f, x_b, *params],
            [batch["mask"][..., :256].contiguous(),
             batch["mask"][..., 256:].contiguous()])
        return [*outs, *grads]

    fwd_bwd(inputs(0))
    gru.KERNEL.prepare(BATCH, 256)
    gru.BACKWARD_KERNEL.prepare(BATCH, 256)
    graph = CapturedStep(fwd_bwd, inputs(0))
    recorded = (graph.launches.get(gru.KERNEL, 0),
                graph.launches.get(gru.BACKWARD_KERNEL, 0))
    check(recorded == (1, 1), f"graph probe: the capture recorded "
                              f"{recorded} GRU launches, expected (1, 1)")
    diffs = []
    for seed in (1, 2):
        batch = inputs(seed)
        got = [t.clone() for t in graph.replay(batch, 0, 0.0)]
        diffs.append(max((a - b).abs().max().item()
                         for a, b in zip(got, fwd_bwd(batch))))
    check(max(diffs) == 0.0, f"graph probe: replay against eager {diffs}")
    replay_ms = cuda_time_ms(lambda: graph.replay(inputs(3), 0, 0.0), 20)
    spreads = determinism_spreads(fwd_bwd, inputs(4))
    print(f"[graphs] GRU forward + backward (B={BATCH}, H=256) captured: "
          f"one launch of each recorded; two replays on new inputs equal "
          f"eager launches bit for bit; {replay_ms:.3f} ms a replay "
          f"(input copies included)", flush=True)
    return dict(recorded=recorded, max_abs_diff=max(diffs),
                replay_ms=replay_ms, repeat_spreads=spreads)


def determinism_spreads(gru_fwd_bwd, batch, repeats: int = 10) -> dict:
    """Why float32 steps on the card do not repeat bit for bit and bf16
    ones do: the largest difference over ``repeats`` runs of the same
    inputs, for the GRU kernels (forward and backward) and for bilinear
    upsampling's backward on the FiLM text map (float32 atomic adds; its
    incoming gradient in float32 and as bf16 values)."""
    import torch.nn.functional as F

    def spread(fn):
        first = [t.clone() for t in fn()]
        return max(max((a - b).abs().max().item()
                       for a, b in zip(fn(), first))
                   for _ in range(repeats))

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(BATCH, 512, 1, 28, device="cuda", generator=gen,
                    requires_grad=True)
    grad = torch.randn(BATCH, 512, 1, 448, device="cuda", generator=gen)

    def upsample_backward(g):
        y = F.interpolate(x, size=(1, 448), mode="bilinear",
                          align_corners=False)
        return torch.autograd.grad(y, [x], g)

    result = dict(
        gru=spread(lambda: gru_fwd_bwd(batch)),
        upsample_backward_f32=spread(lambda: upsample_backward(grad)),
        upsample_backward_bf16_values=spread(
            lambda: upsample_backward(grad.bfloat16().float())))
    print(f"[graphs] the same inputs {repeats + 1} times: the GRU kernels "
          f"differ by {result['gru']:.3e}; bilinear upsampling's backward "
          f"(16, 512, 1, 28) <- 448 columns by "
          f"{result['upsample_backward_f32']:.3e} with a float32 gradient "
          f"and {result['upsample_backward_bf16_values']:.3e} with bf16 "
          f"values", flush=True)
    check(result["gru"] == 0.0, f"the GRU kernels do not repeat: {result}")
    return result


def phase_multi_step(gru, card: str) -> dict:
    """v2 at full width, bf16, batch 16: graph replays against eager steps
    from one saved state (bit for bit, with cudnn.deterministic), the
    eval step the same way, then wall against device time per step for K
    in {1, 4, 16}."""
    import copy

    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.train import (
        build_eval_step, build_multi_eval_step, build_multi_train_step,
        build_train_step)
    from vae_gan_mark_tpu_torch.train.loop import make_generator

    result = dict(probe=phase_graph_probe(gru))
    cfg = get_config("v2", compute_dtype="bfloat16")
    state, vgg = make_trainer(cfg, train_weights(cfg), "cuda")
    single = build_train_step(cfg)
    batches = [train_batch(cfg, BATCH, 600 + i, "cuda")
               for i in range(TIMED_STEPS)]
    torch.backends.cudnn.deterministic = True
    try:
        # One eager group: Adam's state and the signature's warm-up.
        state, _ = build_multi_train_step(cfg)(state, vgg, batches[:MULTI_K],
                                               0, 1e-3)
        saved = copy.deepcopy(state)
        eager, sums_e = copy.deepcopy(saved), None
        for batch in batches[:8]:
            eager, m = single(eager, vgg, batch, make_generator(
                "cuda", 0, eager.step), 1e-3)
            sums_e = m if sums_e is None else {k: sums_e[k] + m[k]
                                               for k in sums_e}
        replayed, multi = copy.deepcopy(saved), build_multi_train_step(cfg)
        torch.cuda.synchronize()
        gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
        sums_g = None
        for i in range(0, 8, MULTI_K):
            replayed, sums_g = multi(replayed, vgg, batches[i:i + MULTI_K],
                                     0, 1e-3, sums_g)
        torch.cuda.synchronize()
        launches = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        check(launches == (16, 16), f"8 replayed steps: GRU launches "
                                    f"{launches}, expected (16, 16)")
        a, b = state_tensors(eager), state_tensors(replayed)
        check(a.keys() == b.keys(), "replayed state has other tensors")
        state_diff = max_abs_diff(a, b)
        metric_diff = max(abs(float(sums_e[k]) - float(sums_g[k]))
                          for k in sums_e)
        print(f"[graphs] 8 bf16 steps at bs={BATCH} from one state, cuDNN "
              f"deterministic: eager against 2 groups of {MULTI_K} graph "
              f"replays: G, D, BN statistics, u, both Adams differ by "
              f"{state_diff:.3e}, the summed metrics by {metric_diff:.3e} "
              f"(limit 0: bit for bit); GRU launches {launches}",
              flush=True)
        check(state_diff == 0.0 and metric_diff == 0.0
              and eager.step == replayed.step,
              f"graph replays against eager: state {state_diff}, metrics "
              f"{metric_diff}")
        del eager, multi, a, b
        result["plain_adam_max_abs_diff"] = plain_adam_reading(
            saved, vgg, single, batches[0], cfg)
        del saved

        # The eval step: eager warm-up, then a group of K replays.
        val = batches[8:8 + MULTI_K]
        idxs = list(range(MULTI_K))
        build_multi_eval_step(cfg)(replayed, vgg, val, idxs, 0, 1e-3)
        multi_eval = build_multi_eval_step(cfg)
        got, fake0 = multi_eval(replayed, vgg, val, idxs, 0, 1e-3)
        eval_step = build_eval_step(cfg)
        ref = [eval_step(replayed, vgg, v, make_generator(
            "cuda", 0, i, replayed.step), 1e-3) for i, v in zip(idxs, val)]
        eval_diff = max(max(abs(float(g[k]) - float(r[0][k])) for k in g)
                        for g, r in zip(got, ref))
        fake_diff = (fake0 - ref[0][1]).abs().max().item()
        print(f"[graphs] eval: {MULTI_K} val batches as graph replays "
              f"against eager eval steps: metrics differ by {eval_diff:.3e},"
              f" batch 0's patches by {fake_diff:.3e} (limit 0)",
              flush=True)
        check(eval_diff == 0.0 and fake_diff == 0.0,
              f"eval replays against eager: {eval_diff}, {fake_diff}")
        result.update(state_max_abs_diff=state_diff,
                      metric_max_abs_diff=metric_diff,
                      eval_max_abs_diff=max(eval_diff, fake_diff),
                      launches_8_steps=launches)
        del multi_eval, got, fake0, ref
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    result["wall_vs_device"] = wall_vs_device(replayed, vgg, cfg, single,
                                              batches, card)
    del replayed, batches
    torch.cuda.empty_cache()
    return result


def plain_adam_reading(saved, vgg, single, batch, cfg) -> float:
    """Why the port's Adams are capturable for every K: one step from
    ``saved`` with its capturable Adams against the same step with plain
    ones loaded from the same state (bias corrections in float32 on the
    card against double precision on the host): the largest parameter
    difference."""
    import copy

    from vae_gan_mark_tpu_torch.train.loop import make_generator
    from vae_gan_mark_tpu_torch.train.state import load_optimizer_state

    after = []
    for plain in (False, True):
        state = copy.deepcopy(saved)
        if plain:
            for name, module, lr in (("opt_g", state.generator, cfg.lr_g),
                                     ("opt_d", state.discriminator,
                                      cfg.lr_d)):
                opt = torch.optim.Adam(module.parameters(), lr=lr,
                                       betas=(cfg.adam_b1, cfg.adam_b2),
                                       eps=1e-8)
                load_optimizer_state(opt, getattr(state, name).state_dict())
                setattr(state, name, opt)
        state, _ = single(state, vgg, batch, make_generator(
            "cuda", 0, state.step), 1e-3)
        after.append({k: v.detach().clone() for k, v in
                      state_tensors(state).items() if k[:2] in ("G.", "D.")})
        del state
    diff = max_abs_diff(*after)
    print(f"[graphs] one step with capturable Adams against plain ones from "
          f"the same state: parameters differ by {diff:.3e}", flush=True)
    return diff


def wall_vs_device(state, vgg, cfg, single, batches, card: str) -> dict:
    """ms a step for K = 1 (eager, a generator a step as the Trainer makes
    it) and K = 4, 16 (replays): the host clock over TIMED_STEPS steps, the
    device busy time of one profiled group, the idle share."""
    from vae_gan_mark_tpu_torch.train import build_multi_train_step
    from vae_gan_mark_tpu_torch.train.loop import make_generator

    rows = {}
    for k in (1, 4, 16):
        multi = build_multi_train_step(cfg) if k > 1 else None

        def group(start, multi=multi, k=k):
            nonlocal state
            chunk = [batches[(start + j) % len(batches)] for j in range(k)]
            if multi is None:
                state, _ = single(state, vgg, chunk[0], make_generator(
                    "cuda", 0, state.step), 1e-3)
            else:
                state, _ = multi(state, vgg, chunk, 0, 1e-3)

        for start in range(0, 2 * k, k):      # warm-up and capture
            group(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, TIMED_STEPS, k):
            group(start)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        prof = profile_call(lambda: (group(0), torch.cuda.synchronize()),
                            f"one group of K={k} bf16 steps", wall_ms * k)
        busy_ms = prof["device_busy_ms"] / k
        rows[k] = dict(wall_ms=wall_ms, device_ms=busy_ms,
                       idle_share=1.0 - busy_ms / wall_ms,
                       wall_over_device=wall_ms / busy_ms,
                       classes=prof["classes"])
        del multi
        torch.cuda.empty_cache()
    print(f"[graphs] bf16 bs={BATCH} step on {card}, wall by the host clock "
          f"over {TIMED_STEPS} steps, device busy from one profiled group:",
          flush=True)
    for k, r in rows.items():
        how = "eager" if k == 1 else "graph replays"
        print(f"[graphs]   K={k:2d} ({how}): wall {r['wall_ms']:.2f} ms, "
              f"device {r['device_ms']:.2f} ms, idle share "
              f"{r['idle_share']:.3f}, wall/device {r['wall_over_device']:.3f}"
              f" (the target of ROADMAP item 7, within ~10%: a reading, not "
              f"a check)", flush=True)
    return rows


def phase_multi_step_driver(gru) -> dict:
    """``Trainer.fit`` with multi_step=4 at full width, bf16, batch 16 (16
    steps and 2 val batches an epoch), cudnn.deterministic: run A for 2
    epochs, resumed with multi_step=1 for a third, against run B, 3 epochs
    with multi_step=4, bit for bit; the GRU launches of every fit; one
    replay's launches against the kernel names in its profile; the train
    CLI with --multi-step 4."""
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.train.loop import Trainer

    cfg = get_config("v2", compute_dtype="bfloat16", batch_size=BATCH,
                     **{"scheduler.patience": 0})
    steps = DRIVER_TRAIN_SAMPLES // BATCH
    val_batches = DRIVER_VAL_SAMPLES // BATCH
    train_data = DeviceResidentSynthetic(
        SyntheticPatchDataset(cfg, DRIVER_TRAIN_SAMPLES, seed=0), BATCH,
        steps)
    val_data = DeviceResidentSynthetic(
        SyntheticPatchDataset(cfg, DRIVER_VAL_SAMPLES, seed=1), BATCH,
        val_batches, advance_per_epoch=False)
    wd_a, wd_b = (os.path.join(RUNS_DIR, n) for n in ("multi_a", "multi_b"))

    def fit(trainer, epochs, what):
        runs = epochs - trainer.epoch
        torch.cuda.synchronize()
        gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
        t = time.perf_counter()
        trainer.fit(epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(forward=gru.KERNEL.launches,
                        backward=gru.BACKWARD_KERNEL.launches)
        expected = dict(forward=runs * (2 * steps + 2 * val_batches),
                        backward=runs * 2 * steps)
        check(launches == expected, f"{what}: GRU launches {launches}, "
                                    f"expected {expected}")
        rates = [r["train/images_per_sec"]
                 for r in read_records(trainer.workdir)[-runs:]]
        print(f"[graphs] {what}: fit({epochs}) in {seconds:.1f} s, GRU "
              f"launches {launches} (2 + 2 a train step, 2 a val batch, "
              f"replays included), train/images_per_sec "
              f"{[round(r, 1) for r in rates]}", flush=True)
        return dict(seconds=seconds, launches=launches, img_per_s=rates)

    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    result = {}
    torch.backends.cudnn.deterministic = True
    try:
        run_a = Trainer(cfg, train_data, val_data, wd_a, seed=0,
                        multi_step=MULTI_K)
        result["run_a"] = fit(run_a, 2, f"run A (multi_step={MULTI_K})")
        del run_a
        resumed = Trainer(cfg, train_data, val_data, wd_a, seed=0,
                          multi_step=1)
        result["resumed"] = fit(resumed, 3, "run A resumed with multi_step=1")
        a_final = group_state_tensors(resumed.state)
        del resumed
        run_b = Trainer(cfg, train_data, val_data, wd_b, seed=0,
                        multi_step=MULTI_K)
        result["run_b"] = fit(run_b, 3, f"run B (multi_step={MULTI_K})")
        b_final = state_tensors(run_b.state)
        diff = max_abs_diff(a_final, b_final)
        rec_a, rec_b = (read_records(wd)[-1] for wd in (wd_a, wd_b))
        rec_same = all(rec_a[k] == rec_b[k] for k in rec_b
                       if k not in UNTIMED)
        print(f"[graphs] A (K={MULTI_K} 2 epochs, then K=1) against B (K="
              f"{MULTI_K} 3 epochs): G, D, buffers and both Adams differ by "
              f"{diff:.3e}, the epoch-3 records equal: {rec_same} (limit: "
              f"bit for bit)", flush=True)
        check(diff == 0.0 and rec_same, f"multi-step A against B: {diff}, "
                                        f"records equal {rec_same}")
        result["a_vs_b_max_abs_diff"] = diff
        del a_final, b_final

        # One replayed group, its counts against its profile's kernels.
        batches = [run_b._put(b) for b in list(train_data(3))[:MULTI_K]]
        torch.cuda.synchronize()
        gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_b.state, _ = run_b.multi_train_step(
                run_b.state, run_b.vgg, batches, 0, 1e-3)
            torch.cuda.synchronize()
        counted = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        traced = [sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and name in e.key)
                  for name in ("gru_fwd_kernel", "gru_bwd_kernel")]
        print(f"[graphs] one group of {MULTI_K} replays: counts "
              f"{counted}, kernels in its profile {tuple(traced)}",
              flush=True)
        check(counted == tuple(traced) == (2 * MULTI_K, 2 * MULTI_K),
              f"replay counts {counted} against profile {traced}")
        result["profile_cross_check"] = dict(counted=counted, traced=traced)
        del run_b, batches
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False

    try:
        cli_dir = os.path.join(RUNS_DIR, "multi_cli")
        run_cli("vae_gan_mark_tpu_torch.train", "--synthetic",
                "--synthetic-samples", "64", "--batch-size", "16",
                "--epochs", "1", "--multi-step", str(MULTI_K), "--workdir",
                cli_dir)
        result["cli"] = "exit 0"
    finally:
        shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return result


# Phase 10: oldv at 448x64.
def phase_oldv(gru, card: str) -> dict:
    """oldv at full width: serving in bf16 and f32 (img/s, 2 GRU launches a
    chunk, CUDA against CPU), 5 bf16 train steps (ms a step, 2 + 2 GRU
    launches a step), one f32 step CUDA against CPU at B=2 with phase 7's
    limits, and a profiled bf16 step by kernel class."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.serve import InferenceEngine
    from vae_gan_mark_tpu_torch.train import build_train_step

    cfgs = {name: get_config("oldv", compute_dtype=name)
            for name in ("bfloat16", "float32")}
    weights = train_weights(cfgs["float32"])
    result = dict(serve={})
    requests = make_requests(cfgs["float32"], BATCH, seed=31)
    outs = {}
    for name, cfg in cfgs.items():
        engine = InferenceEngine(cfg, weights[0], batch_size=BATCH, seed=0,
                                 device="cuda")
        engine.generate(*requests)
        torch.cuda.synchronize()
        gru.KERNEL.launches = 0
        outs[name] = engine.generate(*requests)
        torch.cuda.synchronize()
        launches = gru.KERNEL.launches
        check(launches == 2, f"oldv {name} generate(16): {launches} GRU "
                             f"launches, expected 2")
        check_patches(outs[name], BATCH, cfg, f"oldv {name} generate(16)")
        iters = 20
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.generate(*requests)
        dt = time.perf_counter() - t0
        result["serve"][name] = dict(img_per_s=iters * BATCH / dt,
                                     batch_ms=dt / iters * 1e3,
                                     launches=launches)
        print(f"[oldv] serve {name} bs={BATCH}: {iters * BATCH / dt:.1f} "
              f"img/s ({dt / iters * 1e3:.2f} ms a batch), {launches} GRU "
              f"launches a chunk on {card}", flush=True)
        del engine
    cpu_out = InferenceEngine(cfgs["float32"], weights[0], batch_size=BATCH,
                              seed=0, device="cpu").generate(*requests)
    device_err = float(np.abs(cpu_out - outs["float32"]).max())
    print(f"[oldv] serve CUDA against CPU, float32 (TF32 off): max abs err "
          f"{device_err:.3e} (limit {DEVICE_ATOL})", flush=True)
    check(device_err <= DEVICE_ATOL, f"oldv CUDA against CPU {device_err}")
    result["serve"]["device_max_abs_err"] = device_err

    cfg = cfgs["bfloat16"]
    state, vgg = make_trainer(cfg, weights, "cuda")
    step = build_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [train_batch(cfg, BATCH, 700 + i, "cuda")
               for i in range(TRAIN_STEPS)]
    state, _ = step(state, vgg, batches[0], gen, 1e-3)      # warm-up
    torch.cuda.synchronize()
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    t0 = time.perf_counter()
    for batch in batches:
        state, metrics = step(state, vgg, batch, gen, 1e-3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
    losses = {k: float(v) for k, v in metrics.items()}
    check(launches == (2 * TRAIN_STEPS, 2 * TRAIN_STEPS),
          f"oldv train: GRU launches {launches}, expected 2 + 2 a step")
    check(all(np.isfinite(v) for v in losses.values()),
          f"oldv train: non-finite losses {losses}")
    print(f"[oldv] train bf16 bs={BATCH}: {step_ms:.1f} ms a step "
          f"({BATCH / step_ms * 1e3:.1f} img/s) over {TRAIN_STEPS} steps, GRU "
          f"launches {launches}; last losses " + " ".join(
              f"{k}={v:.4f}" for k, v in losses.items()), flush=True)
    result["train"] = dict(step_ms=step_ms, launches=launches, losses=losses)
    result["profile"] = profile_call(
        lambda: (step(state, vgg, batches[0], gen, 1e-3),
                 torch.cuda.synchronize()),
        f"oldv bf16 train step bs={BATCH}", step_ms)
    del state, vgg, batches
    torch.cuda.empty_cache()
    result["cuda_vs_cpu"] = compare_devices(cfgs["float32"], weights,
                                            one_thread=False,
                                            u_atol=OLDV_U_ATOL)
    return result


KERNEL_CLASSES = (  # first match wins; matched against the kernel's name
    ("gru forward kernel", ("gru_fwd_kernel",)),
    ("gru backward kernel", ("gru_bwd_kernel",)),
    ("conv3x3 probe kernel", ("conv3x3_kernel",)),
    ("conv dgrad", ("dgrad",)),
    ("conv wgrad", ("wgrad",)),
    ("upsample", ("upsample",)),
    ("convolution", ("conv", "implicit_gemm", "xmma", "fft", "winograd",
                     "pointwise_mult_and_sum_complex",
                     "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul", ("gemm", "gemv", "splitK")),
    ("optimizer", ("adam", "Adam", "multi_tensor")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
)


def kernel_class(name: str) -> str:
    for cls, needles in KERNEL_CLASSES:
        if any(n in name for n in needles):
            return cls
    return "other elementwise / reduction"


def profile_call(fn, what: str, unprofiled_ms: float) -> dict:
    """Device time by kernel class for one call that ends synchronised. The
    idle share is 1 - busy / the wall time of that same profiled call, which
    includes the profiler's own host work; device time above the wall time
    would be a double count and fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies, memsets): a CPU op's own
    # row repeats the device time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms <= wall_ms * 1.01,
          f"profile of {what}: device busy {busy_ms:.2f} ms exceeds the "
          f"call's wall time {wall_ms:.2f} ms")
    classes = {}
    for e in events:
        cls = kernel_class(e.key)
        ms, count = classes.get(cls, (0.0, 0))
        classes[cls] = (ms + e.self_device_time_total / 1e3, count + e.count)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    result = dict(unprofiled_ms=unprofiled_ms, profiled_wall_ms=wall_ms,
                  device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                  idle_share_vs_unprofiled=1.0 - busy_ms / unprofiled_ms,
                  classes=classes,
                  top=[(e.key[:100], e.self_device_time_total / 1e3, e.count)
                       for e in top])
    print(f"[profile] {what}: {wall_ms:.2f} ms profiled "
          f"({unprofiled_ms:.2f} ms unprofiled), device busy {busy_ms:.2f} ms,"
          f" idle share {result['idle_share']:.3f} "
          f"({result['idle_share_vs_unprofiled']:.3f} against the unprofiled "
          f"time)", flush=True)
    for cls, (ms, count) in sorted(classes.items(), key=lambda i: -i[1][0]):
        print(f"[profile]   {ms:8.3f} ms  {count:5d} launches  {cls}",
              flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vae_gan_mark_tpu_torch.ops import conv_probe, gru

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    build = phase_build([gru.KERNEL, gru.BACKWARD_KERNEL, conv_probe.KERNEL])
    forward = phase_gru_forward(gru)
    backward = phase_gru_backward(gru)
    conv = phase_conv(conv_probe)
    serve = phase_serve(gru, card)
    train = phase_train(gru, card)
    driver = phase_epoch_driver(gru, card, train["rates"])
    t_new = time.perf_counter()
    multi = phase_multi_step(gru, card)
    multi_driver = phase_multi_step_driver(gru)
    t_oldv = time.perf_counter()
    oldv = phase_oldv(gru, card)
    new_phases_s = dict(multi_step=t_oldv - t_new,
                        oldv=time.perf_counter() - t_oldv)
    print(f"[done] phase 9 took {new_phases_s['multi_step']:.1f} s, phase "
          f"10 {new_phases_s['oldv']:.1f} s", flush=True)

    fwd_row, fwd_row_128 = (next(r for r in forward["rows"]
                                 if r["H"] == 256 and r["B"] == b)
                            for b in (BATCH, 128))
    bwd_row = next(r for r in backward["rows"]
                   if r["H"] == 256 and r["B"] == BATCH)
    conv_row = conv["shapes"]["v2_full_res_64ch_f2"]
    train_launches = train["bfloat16"]["launches"]
    kernels = [
        dict(name="gru_forward", route="cuda",
             source="vae_gan_mark_tpu_torch/csrc/gru_fwd.cu",
             replaces="vae_gan_mark_tpu/ops/pallas/gru.py:76",
             launches=train_launches["forward"],
             launches_by_path=dict(
                 serve=serve["launches"],
                 train_bfloat16=train_launches["forward"],
                 train_float32=train["float32"]["launches"]["forward"],
                 epoch_driver_run_b=driver["run_b"]["launches"]["forward"],
                 serve_from_checkpoint=driver["serve"]["launches"],
                 multi_step_graph_8_steps=multi["launches_8_steps"][0],
                 multi_step_run_b=multi_driver["run_b"]["launches"][
                     "forward"],
                 oldv_serve_chunk=oldv["serve"]["bfloat16"]["launches"],
                 oldv_train=oldv["train"]["launches"][0]),
             max_abs_err=max(r["max_abs_err"] for r in forward["rows"]),
             directions_per_launch=fwd_row["directions_per_launch"],
             ms=fwd_row["ms"], single_direction_ms=fwd_row["single_ms"],
             ms_b128=fwd_row_128["ms"],
             waves_b128=fwd_row_128["plan"]["waves"],
             us_per_step=forward["per_step"]["us_per_step"],
             plain_ms=fwd_row["plain_ms"], bound_ms=fwd_row["bound_ms"],
             bound_by=fwd_row["bound_by"], library_ms=fwd_row["library_ms"]),
        dict(name="gru_backward", route="cuda",
             source="vae_gan_mark_tpu_torch/csrc/gru_bwd.cu",
             replaces="vae_gan_mark_tpu/ops/pallas/gru.py:100",
             launches=train_launches["backward"],
             launches_by_path=dict(
                 train_bfloat16=train_launches["backward"],
                 train_float32=train["float32"]["launches"]["backward"],
                 epoch_driver_run_b=driver["run_b"]["launches"]["backward"],
                 multi_step_graph_8_steps=multi["launches_8_steps"][1],
                 multi_step_run_b=multi_driver["run_b"]["launches"][
                     "backward"],
                 oldv_train=oldv["train"]["launches"][1]),
             max_abs_err=max(r["max_abs_err"] for r in backward["rows"]),
             directions_per_launch=bwd_row["directions_per_launch"],
             ms=bwd_row["ms"], kernel_ms=bwd_row["kernel_ms"],
             single_direction_ms=bwd_row["single_ms"],
             plain_ms=bwd_row["plain_ms"], bound_ms=bwd_row["bound_ms"],
             bound_by=bwd_row["bound_by"], library_ms=bwd_row["library_ms"]),
        dict(name="conv3x3_superp", route="cuda",
             source="vae_gan_mark_tpu_torch/csrc/conv3x3.cu",
             replaces="benchmarks/pallas_conv_probe.py:116",
             launches=conv["launches"],
             launches_by_path=dict(probe_shapes=conv["launches"]),
             max_abs_err=max(c["max_abs_err"] for c in conv["checks"]),
             max_rel_err=max(c["rel_err"] for c in conv["checks"]),
             ms=conv_row["ms"], plain_ms=conv_row["plain_ms"],
             bound_ms=conv_row["bound_ms"], bound_by=conv_row["bound_by"],
             library_ms=conv_row["library_ms"]),
    ]
    seconds = time.perf_counter() - t_start

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, seconds=seconds,
                       build=build, gru_forward=forward,
                       gru_backward=backward, conv=conv, serve=serve,
                       train=train, epoch_driver=driver,
                       multi_step=multi, multi_step_driver=multi_driver,
                       oldv=oldv, new_phases_s=new_phases_s,
                       kernels=kernels),
                  f, indent=1,
                  default=str)
    print(f"[done] phases took {seconds:.1f} s", flush=True)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
