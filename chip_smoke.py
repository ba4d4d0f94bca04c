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
8. print the kernels' JSON line and, last, the device line.

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


def compare_devices(cfg, weights) -> dict:
    """One float32 step at B=2, dropout 0, same weights, batch and eps, on
    the card and on the CPU; the CPU step once more on one thread, whose
    spread against the CPU's default threads is sum order alone."""
    import dataclasses

    from vae_gan_mark_tpu_torch.train import build_train_step

    cfg = dataclasses.replace(cfg, char_rnn_dropout=0.0)
    threads = torch.get_num_threads()
    runs = {}
    for device, n_threads in (("cuda", threads), ("cpu", threads),
                              ("cpu_1_thread", 1)):
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
    buffer_err = max(((b_gpu[k] - b_cpu[k]).abs()
                      / (STEP_BUFFER_ATOL + STEP_BUFFER_RTOL
                         * b_cpu[k].abs())).max().item() for k in b_cpu)
    net_max = max(v.abs().max().item() for v in mom_cpu.values())
    zero_err = max((mom_gpu[k] - mom_cpu[k]).abs().max().item()
                   / (STEP_MOMENT_ZERO * net_max) for k in ZERO_GRADIENT_PARAMS)
    devices = l2_spread(mom_gpu, mom_cpu)
    cpu_threads = l2_spread(runs["cpu_1_thread"][2], mom_cpu)
    moment_err = max(devices[-1][0] / STEP_MOMENT_L2, zero_err)
    result = dict(losses_cuda=m_gpu, losses_cpu=m_cpu,
                  loss_max_rel_err=loss_err,
                  buffer_err_over_limit=buffer_err,
                  moment_err_over_limit=moment_err,
                  moment_l2_median=devices[len(devices) // 2][0],
                  worst_moments=devices[-3:],
                  cpu_threads=threads,
                  cpu_1_thread_l2_median=cpu_threads[len(cpu_threads) // 2][0],
                  cpu_1_thread_worst=cpu_threads[-3:],
                  zero_gradient_err_over_limit=zero_err,
                  largest_moment=net_max)
    print(f"[train] CUDA vs CPU float32 step at B=2: losses max rel err "
          f"{loss_err:.2e} (limit {STEP_LOSS_RTOL}), BN/u at "
          f"{buffer_err:.3f} of their limit; G's Adam moments per tensor "
          f"L2 median {result['moment_l2_median']:.2e}, worst "
          f"{devices[-1][0]:.2e} ({devices[-1][1]}; limit {STEP_MOMENT_L2});"
          f" CPU 1 vs {threads} threads: median "
          f"{result['cpu_1_thread_l2_median']:.2e}, worst "
          f"{cpu_threads[-1][0]:.2e}; zero-gradient bias at {zero_err:.3f} "
          f"of its limit", flush=True)
    check(loss_err <= STEP_LOSS_RTOL and buffer_err <= 1.0
          and moment_err <= 1.0, f"CUDA vs CPU train step: {result}")
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
                 train_float32=train["float32"]["launches"]["forward"]),
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
                 train_float32=train["float32"]["launches"]["backward"]),
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
                       train=train, kernels=kernels), f, indent=1,
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
