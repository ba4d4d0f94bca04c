"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. require CUDA and print the card's name and power limit;
2. build the four kernel libraries (``vae_gan_mark_tpu_torch/csrc/gru_fwd.cu``,
   ``gru_bwd.cu``, ``conv3x3.cu``, ``resize_bilinear.cu``) with ``nvcc`` for
   ``sm_90a`` from the
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
5b. the bilinear resize (``resize_bilinear.cu``): the forward against
   ``F.interpolate`` (at most one float32 ulp; how many values differ is
   printed) and the gather backward against ATen's in float64 on the CPU,
   run twice bit for bit, at every shape the port resizes at full width
   and two off its path; times at the main path's shapes against the
   library's, the bound (bytes) and the plain version on the CPU; the
   kernels the library runs; 4 + 4 launches a full-width v2 and oldv train
   step and 4 a val batch; a full-width float32 v2 and oldv step run twice
   with cuDNN's deterministic algorithms, bit for bit. Phases 6, 8 and 9
   count the resize's launches on the main path beside the GRU's: 4 a
   served chunk, 4 + 4 a train step and 4 a val batch, graph replays
   included;
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
11. vanilla at full width (448x64, ``enc_chans=(128,256,512,1024)``, z 128,
   text 64 from a 384-wide sentence embedding, a 4x28 latent) with seeded
   weights through the bridge: serving in bf16 and f32 through
   ``InferenceEngine`` (texts through ``hash_embed``; img/s, a profile,
   CUDA against CPU), 5 bf16 train steps (ms a step, a profile), one f32
   step CUDA against CPU at B=2, 4 graph replays of the bf16 step against
   eager ones (bit for bit, cudnn.deterministic), and lr_sh through
   ``Trainer.fit`` until the plateau lowers both rates; each path with the
   GRU counts at 0 before it and 0 after it (the plain generator runs no
   GRU);
12. the conditional D head: v2 with it, 5 bf16 train steps at bs 16 (2 + 2
   GRU launches a step) and one f32 step CUDA against CPU at B=2; vanilla
   with it (the ``cond_dense`` branch), one f32 step CUDA against CPU;
13. data parallelism (``parallel/``), v2 at full width with
   ``cudnn.deterministic``: 4 bf16 steps at bs 16 in one process with an
   NCCL process group of one against the same steps without a group, bit
   for bit; two processes on the one card (gloo: NCCL refuses two ranks
   on one GPU), 8 rows each of the same 16-row batches, 3 f32 steps,
   against one process at bs 16 (metrics rtol 1e-4, BatchNorm statistics
   and u atol 1e-5), 2 + 2 GRU launches a step in each process;
14. the serving artifact (``serve/export.py``): v2 at full width exported
   in f32 and bf16 at bs 16, each loaded in a fresh process that must not
   import ``models/`` or ``train/``, 40 requests against
   ``InferenceEngine.generate`` with the same seed (max abs 1e-5 in f32,
   2e-2 in bf16), 2 GRU forward launches a chunk inside that process, and
   img/s of artifact and engine at bs 16; then ``python -m
   vae_gan_mark_tpu_torch.doctor``, every check ok;
15. the device loader (``data/device_pipeline.py``): an on-disk dataset of
   24 noise creatives of 1280x720 with 8 quads each (192 samples,
   ``benchmarks/loader_bench.py``'s shapes), ``DeviceWarpLoader`` on the
   card against ``HostWarpLoader`` for v2 448x64 at bs 16 (mean abs per
   stream < 0.02, texts equal), both loaders' img/s over an epoch (the
   copies to the card included) and the warp's ms a batch; the train CLI
   with ``--loader device`` for one bf16 epoch at bs 16, with K=1 and
   K=4 (2 + 2 GRU launches a train step, 2 a val batch), and its refusal
   of ``--patch-cache``;
16. the model axis (``parallel/mesh.py``): 4 processes on the one card
   over gloo, data 2 x model 2, G's widest kernels partitioned
   (``kernel_min_ch`` 512), v2 at full width, f32, both rates 0, 3 steps
   at a global batch of 8 with ``cudnn.deterministic``, against one
   process at 8 rows (phase 13b's limits on the metrics, the BatchNorm
   statistics and u, and the gathered Adam moments), the data ranks'
   blocks equal bit for bit, the generator parameters each rank holds
   (54.96M), 2 + 2 GRU launches a step in each process; then ``python -m
   vae_gan_mark_tpu_torch.parallel.dryrun --processes 4`` at full width;
17. print the kernels' JSON line and, last, the device line.

``python3 chip_smoke.py --dp-worker RANK PORT OUT``, ``--serve-artifact
DIR REQUEST OUT`` and ``--tp-worker RANK PORT OUT`` are phases 13, 14 and
16's child processes.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import hashlib
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
# The plain generator (vanilla, lr_sh) has such a bias ahead of every
# BatchNorm: its encoder's convs and its decoder's transposed convs.
PLAIN_ZERO_GRADIENT_PARAMS = tuple(
    [f"encoder.feat.{i}.bias" for i in (0, 3, 6, 9)]
    + [f"decoder.decode.{i}.bias" for i in (0, 3, 6, 9, 12)])


def zero_gradient_params(cfg) -> tuple:
    if cfg.generator == "plain":
        return PLAIN_ZERO_GRADIENT_PARAMS
    return ("image_vae_decoder_module.bottleneck_proc.0.bias",)


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


# Resize (csrc/resize_bilinear.cu) against F.interpolate on the card on a
# contiguous copy of the input (PyTorch's NCHW kernel, the one the port
# called; its channels-last kernel rounds otherwise): the forward within one
# float32 ulp of each value (how many differ at all is printed), the input
# gradient within RESIZE_GRAD_RTOL of float64 on the CPU, scaled by the same
# gradient of |dy| (the float32 rounding of at most ~34 weighted terms), and
# two float32 backward runs bit for bit.
RESIZE_GRAD_RTOL = 2e-6
# (name, input shape, output (h, w), layout): every call the port makes on
# the card at full width (v2's transposed text map lies in NCHW order at
# batch 16: the pooling's product writes it so; at the serving engine's
# batch 1 it is channels-last), and three off its path, one of them a
# permuted view.
RESIZE_SHAPES = (
    [(f"v2_w{w}", (16, 512, 1, 28), (1, w), "nchw")
     for w in (56, 112, 224, 448)]
    + [(f"oldv_w{w}", (16, 512, 4, 28), (4, w), "nchw")
       for w in (112, 224, 448)]
    + [("oldv_strip", (16, 512, 4, 28), (1, 56), "nchw"),
       ("v2_serve_w448", (1, 512, 1, 28), (1, 448), "channels_last"),
       ("both_axes", (2, 3, 1, 28), (8, 56), "nchw"),
       ("down", (2, 3, 6, 10), (3, 4), "nchw"),
       ("down_permuted", (2, 3, 6, 10), (3, 4), "permuted")])


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 units in the last place, elementwise (int64)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return (ordered(a) - ordered(b)).abs()


def resize_input(gen, shape, layout: str) -> torch.Tensor:
    """NCHW memory, a permuted view of (N, W, H, C) memory, or channels-last
    memory (N, H, W, C)."""
    n, c, h, w = shape
    if layout == "permuted":
        return torch.randn(n, w, h, c, device="cuda",
                           generator=gen).permute(0, 3, 2, 1)
    if layout == "channels_last":
        return torch.randn(n, h, w, c, device="cuda",
                           generator=gen).permute(0, 3, 1, 2)
    return torch.randn(shape, device="cuda", generator=gen)


def upsample_backward(dy: torch.Tensor, in_shape) -> torch.Tensor:
    return torch.ops.aten.upsample_bilinear2d_backward(
        dy, list(dy.shape[2:]), list(in_shape), False)


def resize_counts() -> tuple:
    """The resize kernels' launch counts (forward, backward)."""
    from vae_gan_mark_tpu_torch.ops import resize
    return (resize.RESIZE_KERNEL.launches,
            resize.RESIZE_BACKWARD_KERNEL.launches)


def zero_resize_counts() -> None:
    from vae_gan_mark_tpu_torch.ops import resize
    resize.RESIZE_KERNEL.launches = resize.RESIZE_BACKWARD_KERNEL.launches = 0


def resize_step_launches(resize, variant: str) -> dict:
    """Resize launches over one full-width bf16 train step at batch 16 and
    one val batch, after a warm-up step."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.train import build_eval_step, build_train_step

    cfg = get_config(variant, compute_dtype="bfloat16")
    state, vgg = make_trainer(cfg, train_weights(cfg), "cuda")
    step = build_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = train_batch(cfg, BATCH, 900, "cuda")
    state, _ = step(state, vgg, batch, gen, 1e-3)
    counts = {}
    for name, fn in (("train_step", lambda: step(state, vgg, batch, gen,
                                                 1e-3)),
                     ("val_batch", lambda: build_eval_step(cfg)(
                         state, vgg, batch, gen, 1e-3))):
        torch.cuda.synchronize()
        before = (resize.RESIZE_KERNEL.launches,
                  resize.RESIZE_BACKWARD_KERNEL.launches)
        fn()
        torch.cuda.synchronize()
        counts[name] = (resize.RESIZE_KERNEL.launches - before[0],
                        resize.RESIZE_BACKWARD_KERNEL.launches - before[1])
    check(counts == dict(train_step=(4, 4), val_batch=(4, 0)),
          f"{variant} resize launches {counts}, expected 4 + 4 a train step "
          f"and 4 a val batch")
    print(f"[resize] {variant} full width bs={BATCH}: launches (forward, "
          f"backward) {counts}", flush=True)
    return counts


def float32_step_repeats(variant: str) -> dict:
    """One full-width float32 train step at batch 16 run twice from the same
    weights, batch and generator seed, with cuDNN's deterministic
    algorithms: the tensors that differ and the largest difference of any
    parameter, buffer or Adam moment (0 when the step repeats bit for
    bit)."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.train import build_train_step

    cfg = get_config(variant, compute_dtype="float32")
    weights = train_weights(cfg)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            state, vgg = make_trainer(cfg, weights, "cuda")
            state, _ = build_train_step(cfg)(
                state, vgg, train_batch(cfg, BATCH, 901, "cuda"),
                torch.Generator(device="cuda").manual_seed(0), 1e-3)
            runs.append(state_tensors(state))
            del state, vgg
    finally:
        torch.backends.cudnn.deterministic = saved
    differ = sorted(k for k in runs[0] if not torch.equal(runs[0][k],
                                                           runs[1][k]))
    diff = max_abs_diff(*runs)
    print(f"[resize] {variant} float32 step twice (cudnn.deterministic): "
          f"{len(differ)} of {len(runs[0])} tensors differ, max abs "
          f"{diff:.3e}; first: {differ[:6]}", flush=True)
    check(not differ, f"{variant} float32 step does not repeat: {differ}")
    return dict(tensors=len(runs[0]), differ=differ, max_abs_diff=diff)


def phase_resize(resize) -> dict:
    """The resize kernels against F.interpolate and its backward at every
    shape of RESIZE_SHAPES; their times at the main path's shapes against
    the library's, the bound (bytes) and the plain version on the host's
    CPU; the launches of a full-width train step and val batch of v2 and
    oldv; whether a float32 step repeats bit for bit."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, shape, (oh, ow), layout in RESIZE_SHAPES:
        x = resize_input(gen, shape, layout)
        y = resize.resize_bilinear(x, oh, ow)
        check(y.stride() == F.interpolate(x, size=(oh, ow), mode="bilinear",
                                          align_corners=False).stride(),
              f"resize {name}: strides {y.stride()} are not F.interpolate's")
        ref = F.interpolate(x.contiguous(), size=(oh, ow), mode="bilinear",
                            align_corners=False)
        ulps = ulp_distance(y, ref)
        dy = torch.randn(y.shape, device="cuda", generator=gen)
        dx = resize.resize_bilinear_backward(dy, *shape[2:])
        again = resize.resize_bilinear_backward(dy, *shape[2:])
        torch.cuda.synchronize()
        dy64 = dy.double().cpu()
        ref64 = upsample_backward(dy64, shape)
        scale64 = upsample_backward(dy64.abs(), shape)
        err = ((dx.double().cpu() - ref64).abs()
               / scale64.clamp_min(1e-300)).max().item()
        row = dict(shape=list(shape), out=[oh, ow], layout=layout,
                   max_ulps=int(ulps.max()), unequal=int((ulps > 0).sum()),
                   max_abs_diff=(y - ref).abs().max().item(),
                   outputs=y.numel(), grad_rel_err=err,
                   backward_repeats=torch.equal(dx, again))
        check(row["max_ulps"] <= 1, f"resize {name}: {row['max_ulps']} ulps "
                                    f"from F.interpolate")
        check(err <= RESIZE_GRAD_RTOL, f"resize {name}: gradient {err:.3e} "
                                       f"from float64")
        check(row["backward_repeats"], f"resize {name}: two backward runs "
                                       f"differ")
        if shape[0] == BATCH:                    # the main path's shapes
            # Either way one tensor of each size is read and the other
            # written: x and y forward, dy and dx backward.
            nbytes = 4 * (x.numel() + y.numel())
            row.update(
                ms=device_time_ms(lambda: resize.resize_bilinear(x, oh, ow),
                                  200),
                backward_ms=device_time_ms(
                    lambda: resize.resize_bilinear_backward(dy, *shape[2:]),
                    200),
                library_ms=device_time_ms(lambda: F.interpolate(
                    x, size=(oh, ow), mode="bilinear", align_corners=False),
                    20),
                library_backward_ms=device_time_ms(
                    lambda: upsample_backward(dy, shape), 20),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            x_cpu, dy_cpu = x.cpu(), dy.cpu()
            t0 = time.perf_counter()
            for _ in range(3):
                F.interpolate(x_cpu, size=(oh, ow), mode="bilinear",
                              align_corners=False)
            row["plain_cpu_ms"] = (time.perf_counter() - t0) / 3 * 1e3
            t0 = time.perf_counter()
            for _ in range(3):
                upsample_backward(dy_cpu, shape)
            row["plain_backward_cpu_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        rows[name] = row
        print(f"[resize] {name} {tuple(shape)} -> ({oh}, {ow}): max "
              f"{row['max_ulps']} ulp from F.interpolate ({row['unequal']} "
              f"of {row['outputs']} differ), gradient {err:.2e} of float64 "
              f"(limit {RESIZE_GRAD_RTOL}), backward repeats "
              f"{row['backward_repeats']}" + (
                  f"; forward {row['ms'] * 1e3:.2f} us, backward "
                  f"{row['backward_ms'] * 1e3:.2f} us, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us (bytes); F.interpolate "
                  f"{row['library_ms'] * 1e3:.1f} us, its backward "
                  f"{row['library_backward_ms'] * 1e3:.1f} us; plain on the "
                  f"CPU {row['plain_cpu_ms']:.2f} ms, its backward "
                  f"{row['plain_backward_cpu_ms']:.2f} ms" if "ms" in row
                  else ""),
              flush=True)

    # Which kernel the library runs at v2's largest call.
    x = resize_input(gen, (BATCH, 512, 1, 28), "nchw")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.interpolate(x, size=(1, 448), mode="bilinear", align_corners=False)
        torch.cuda.synchronize()
    library_kernels = sorted({e.key[:80] for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA})
    print(f"[resize] F.interpolate at v2 (16, 512, 1, 28) -> (1, 448) runs "
          f"{library_kernels}", flush=True)
    per_step = {v: sum(rows[n][k] for n in rows
                       if n.startswith(v + "_") and "ms" in rows[n]
                       for k in ("ms", "backward_ms"))
                for v in ("v2", "oldv")}
    print(f"[resize] kernels a train step (forward + backward, every call): "
          f"v2 {per_step['v2'] * 1e3:.1f} us, oldv "
          f"{per_step['oldv'] * 1e3:.1f} us", flush=True)
    return dict(shapes=rows, library_kernels=library_kernels,
                ms_per_step=per_step,
                step_launches={v: resize_step_launches(resize, v)
                               for v in ("v2", "oldv")},
                float32_step={v: float32_step_repeats(v)
                              for v in ("v2", "oldv")})


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
    zero_resize_counts()
    outs = {n: engine.generate(*requests[n]) for n in (16, 5, 33)}
    rendered = engine.render(image, mask_image, quad, "NEW COLLECTION")
    torch.cuda.synchronize()
    launches, resized = gru.KERNEL.launches, resize_counts()
    chunks = sum(-(-n // BATCH) for n in (16, 5, 33)) + 1
    for n, out in outs.items():
        check_patches(out, n, cfg, f"generate({n})")
    check(rendered.shape == image.shape and
          bool(np.all(np.isfinite(rendered))), "render: bad output")
    check(launches == 2 * chunks,
          f"GRU kernel launches {launches}, expected 2 x {chunks} chunks")
    check(resized == (4 * chunks, 0),
          f"resize launches {resized}, expected 4 x {chunks} chunks and no "
          f"backward")
    print(f"[serve] generate 16/5/33 + render: {chunks} chunks, "
          f"{launches} GRU kernel launches, resize launches {resized}",
          flush=True)

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
    return dict(launches=launches, resize_launches=resized, chunks=chunks,
                device_max_abs_err=device_err,
                bf16_max_abs=bf16_max, bf16_mean_abs=bf16_mean,
                img_per_s=throughput, profile=profile)


def train_batch(cfg, n: int, seed: int, device, with_eps: bool = False):
    from vae_gan_mark_tpu_torch.train import batch_to_device

    rng = np.random.default_rng(seed)
    shape = (n, cfg.patch_h, cfg.patch_w)
    if cfg.text_encoder == "sbert":                 # sentence embeddings
        text = rng.normal(0, 1, (n, cfg.sbert_dim)).astype(np.float32)
    else:
        text = rng.integers(1, cfg.vocab_size, (n, cfg.max_text_len))
        text[:, rng.integers(10, cfg.max_text_len):] = 0      # PAD tail
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                 np.float32),
             "text": text}
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
            discriminator_state_dict_from_jax(
                *random_discriminator_tree(1, cfg), cfg),
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
    zero_resize_counts()
    t0 = time.perf_counter()
    history = []
    for batch in batches:
        state, metrics = step(state, vgg, batch, gen, 1e-3)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(forward=gru.KERNEL.launches,
                    backward=gru.BACKWARD_KERNEL.launches)
    resized = resize_counts()
    check(launches == dict(forward=2 * TRAIN_STEPS,
                           backward=2 * TRAIN_STEPS),
          f"{name} train: GRU launches {launches}, expected 2 + 2 per step "
          f"over {TRAIN_STEPS} steps")
    check(resized == (4 * TRAIN_STEPS, 4 * TRAIN_STEPS),
          f"{name} train: resize launches {resized}, expected 4 + 4 per "
          f"step over {TRAIN_STEPS} steps")
    history = [{k: float(v) for k, v in m.items()} for m in history]
    check(all(np.isfinite(v) for m in history for v in m.values()),
          f"{name} train: non-finite losses {history}")
    after = watched_buffers(state)
    moved = {kind: any(not torch.equal(before[k], after[k])
                       for k in before if kind in k)
             for kind in ("running_mean", "running_var", "weight_u")}
    check(all(moved.values()), f"{name} train: buffers did not move {moved}")
    print(f"[train] {name} {TRAIN_STEPS} steps bs={BATCH}: {seconds:.2f} s "
          f"(first step included), GRU launches {launches}, resize "
          f"launches {resized}, last losses "
          + " ".join(f"{k}={v:.4f}" for k, v in history[-1].items()),
          flush=True)
    return dict(state=state, vgg=vgg, step=step, gen=gen,
                result=dict(launches=launches, resize_launches=resized,
                            losses=history,
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


def l2_spread(a: dict, b: dict, zero_gradient: tuple) -> list:
    """Per-tensor ||a - b|| / ||b|| over the moments, sorted, largest
    last; the zero-gradient parameters left out."""
    return sorted(((a[k] - b[k]).norm().item()
                   / max(b[k].norm().item(), 1e-30), k)
                  for k in b if k not in zero_gradient)


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
    zero_gradient = zero_gradient_params(cfg)
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
                   / (STEP_MOMENT_ZERO * net_max) for k in zero_gradient)
    devices = l2_spread(mom_gpu, mom_cpu, zero_gradient)
    cpu_threads = (l2_spread(runs["cpu_1_thread"][2], mom_cpu, zero_gradient)
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


def read_records(workdir: str, run: str = "v2") -> list:
    with open(os.path.join(workdir, f"{run}.metrics.jsonl")) as f:
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
    from vae_gan_mark_tpu_torch.train.loop import Trainer
    from vae_gan_mark_tpu_torch.train.schedule import kl_weight_for_epoch
    from vae_gan_mark_tpu_torch.train.state import get_lr
    from vae_gan_mark_tpu_torch.train.step import make_generator

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
        zero_resize_counts()
        t = time.perf_counter()
        trainer.fit(epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(forward=gru.KERNEL.launches,
                        backward=gru.BACKWARD_KERNEL.launches)
        resized = resize_counts()
        expected = dict(forward=runs * (2 * steps + 2 * val_batches),
                        backward=runs * 2 * steps)
        check(launches == expected,
              f"{what}: GRU launches {launches}, expected {expected} (2 + 2 "
              f"per train step, 2 forward per val batch)")
        expected_resize = (runs * 4 * (steps + val_batches), runs * 4 * steps)
        check(resized == expected_resize,
              f"{what}: resize launches {resized}, expected "
              f"{expected_resize} (4 + 4 per train step, 4 forward per val "
              f"batch)")
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
              f"launches {launches}, resize launches {resized}", flush=True)
        return dict(seconds=seconds, launches=launches,
                    resize_launches=resized, records=records,
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
        zero_resize_counts()
        patches = engine.generate(*requests)
        torch.cuda.synchronize()
        serve_launches, serve_resized = gru.KERNEL.launches, resize_counts()
        check(serve_launches == 2, f"from_checkpoint generate(16): "
                                   f"{serve_launches} GRU launches, expected 2")
        check(serve_resized == (4, 0), f"from_checkpoint generate(16): "
                                       f"resize launches {serve_resized}, "
                                       f"expected (4, 0)")
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
        result["serve"] = dict(launches=serve_launches,
                               resize_launches=serve_resized, equal=same)
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
    from vae_gan_mark_tpu_torch.config import get_config
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
    gru.prepare_capture(get_config("v2"), BATCH, backward=True)   # H=256
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
    """Whether the card's kernels repeat: the largest difference over
    ``repeats`` runs of the same inputs, for the GRU kernels (forward and
    backward) and for the resize's gather backward on the FiLM text map
    (``ops/resize.py``)."""
    from vae_gan_mark_tpu_torch.ops.resize import interpolate_bilinear

    def spread(fn):
        first = [t.clone() for t in fn()]
        return max(max((a - b).abs().max().item()
                       for a, b in zip(fn(), first))
                   for _ in range(repeats))

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(BATCH, 512, 1, 28, device="cuda", generator=gen,
                    requires_grad=True)
    grad = torch.randn(BATCH, 512, 1, 448, device="cuda", generator=gen)

    result = dict(
        gru=spread(lambda: gru_fwd_bwd(batch)),
        resize_backward=spread(lambda: torch.autograd.grad(
            interpolate_bilinear(x, 1, 448), [x], grad)))
    print(f"[graphs] the same inputs {repeats + 1} times: the GRU kernels "
          f"differ by {result['gru']:.3e}; the resize's backward "
          f"(16, 512, 1, 28) <- 448 columns by "
          f"{result['resize_backward']:.3e}", flush=True)
    check(result["gru"] == 0.0 and result["resize_backward"] == 0.0,
          f"the port's kernels do not repeat: {result}")
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
    from vae_gan_mark_tpu_torch.train.step import make_generator

    result = dict(probe=phase_graph_probe(gru))
    cfg = get_config("v2", compute_dtype="bfloat16")
    state, vgg = make_trainer(cfg, train_weights(cfg), "cuda")
    single = build_train_step(cfg)
    batches = [train_batch(cfg, BATCH, 600 + i, "cuda")
               for i in range(TIMED_STEPS)]
    torch.backends.cudnn.deterministic = True
    try:
        # One eager step of the multi step that replays: Adam's state and
        # the signature's warm-up. A graph stays with the state it was
        # captured with, so the capture waits for the copy below.
        multi = build_multi_train_step(cfg)
        state, _ = multi(state, vgg, batches[:1], 0, 1e-3)
        saved = copy.deepcopy(state)
        eager, sums_e = copy.deepcopy(saved), None
        for batch in batches[:8]:
            eager, m = single(eager, vgg, batch, make_generator(
                "cuda", 0, eager.step), 1e-3)
            sums_e = m if sums_e is None else {k: sums_e[k] + m[k]
                                               for k in sums_e}
        replayed = copy.deepcopy(saved)
        torch.cuda.synchronize()
        gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
        zero_resize_counts()
        sums_g = None
        for i in range(0, 8, MULTI_K):
            replayed, sums_g = multi(replayed, vgg, batches[i:i + MULTI_K],
                                     0, 1e-3, sums_g)
        torch.cuda.synchronize()
        launches = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        resized = resize_counts()
        check(launches == (16, 16), f"8 replayed steps: GRU launches "
                                    f"{launches}, expected (16, 16)")
        check(resized == (32, 32), f"8 replayed steps: resize launches "
                                   f"{resized}, expected (32, 32)")
        a, b = state_tensors(eager), state_tensors(replayed)
        check(a.keys() == b.keys(), "replayed state has other tensors")
        state_diff = max_abs_diff(a, b)
        metric_diff = max(abs(float(sums_e[k]) - float(sums_g[k]))
                          for k in sums_e)
        print(f"[graphs] 8 bf16 steps at bs={BATCH} from one state, cuDNN "
              f"deterministic: eager against 2 groups of {MULTI_K} graph "
              f"replays: G, D, BN statistics, u, both Adams differ by "
              f"{state_diff:.3e}, the summed metrics by {metric_diff:.3e} "
              f"(limit 0: bit for bit); GRU launches {launches}, resize "
              f"launches {resized}",
              flush=True)
        check(state_diff == 0.0 and metric_diff == 0.0
              and eager.step == replayed.step,
              f"graph replays against eager: state {state_diff}, metrics "
              f"{metric_diff}")
        del eager, multi, a, b
        result["plain_adam_max_abs_diff"] = plain_adam_reading(
            saved, vgg, single, batches[0], cfg)
        del saved

        # The eval step: a group with the eager warm-up and the capture,
        # then a group of K replays.
        val = batches[8:8 + MULTI_K]
        idxs = list(range(MULTI_K))
        multi_eval = build_multi_eval_step(cfg)
        multi_eval(replayed, vgg, val, idxs, 0, 1e-3)
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
                      launches_8_steps=launches,
                      resize_launches_8_steps=resized)
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

    from vae_gan_mark_tpu_torch.train.state import load_optimizer_state
    from vae_gan_mark_tpu_torch.train.step import make_generator

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
    from vae_gan_mark_tpu_torch.train.step import make_generator

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
        zero_resize_counts()
        t = time.perf_counter()
        trainer.fit(epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(forward=gru.KERNEL.launches,
                        backward=gru.BACKWARD_KERNEL.launches)
        resized = resize_counts()
        expected = dict(forward=runs * (2 * steps + 2 * val_batches),
                        backward=runs * 2 * steps)
        check(launches == expected, f"{what}: GRU launches {launches}, "
                                    f"expected {expected}")
        expected_resize = (runs * 4 * (steps + val_batches), runs * 4 * steps)
        check(resized == expected_resize, f"{what}: resize launches "
                                          f"{resized}, expected "
                                          f"{expected_resize}")
        rates = [r["train/images_per_sec"]
                 for r in read_records(trainer.workdir)[-runs:]]
        print(f"[graphs] {what}: fit({epochs}) in {seconds:.1f} s, GRU "
              f"launches {launches} (2 + 2 a train step, 2 a val batch, "
              f"replays included), resize launches {resized} (4 + 4, 4), "
              f"train/images_per_sec {[round(r, 1) for r in rates]}",
              flush=True)
        return dict(seconds=seconds, launches=launches,
                    resize_launches=resized, img_per_s=rates)

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
        zero_resize_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_b.state, _ = run_b.multi_train_step(
                run_b.state, run_b.vgg, batches, 0, 1e-3)
            torch.cuda.synchronize()
        counted = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches,
                   *resize_counts())
        traced = [sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and name in e.key)
                  for name in ("gru_fwd_kernel", "gru_bwd_kernel",
                               "upsample_bilinear_fwd_kernel",
                               "upsample_bilinear_bwd_kernel")]
        print(f"[graphs] one group of {MULTI_K} replays: counts (GRU "
              f"forward, backward, resize forward, backward) {counted}, "
              f"kernels in its profile {tuple(traced)}", flush=True)
        check(counted == tuple(traced) == (2 * MULTI_K, 2 * MULTI_K,
                                           4 * MULTI_K, 4 * MULTI_K),
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


def gru_counts(gru) -> tuple:
    return gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches


def zero_gru_counts(gru) -> None:
    torch.cuda.synchronize()
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0


def timed_train_steps(gru, cfg, state, vgg, seed: int, what: str,
                      per_step: tuple) -> dict:
    """One warm-up step, then TRAIN_STEPS steps at batch BATCH with the
    GRU counts at 0 just before them; fails unless they launched
    ``per_step`` (forward, backward) a step and the losses are finite."""
    from vae_gan_mark_tpu_torch.train import build_train_step

    step = build_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [train_batch(cfg, BATCH, seed + i, "cuda")
               for i in range(TRAIN_STEPS)]
    state, _ = step(state, vgg, batches[0], gen, 1e-3)      # warm-up
    zero_gru_counts(gru)
    t0 = time.perf_counter()
    for batch in batches:
        state, metrics = step(state, vgg, batch, gen, 1e-3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = gru_counts(gru)
    losses = {k: float(v) for k, v in metrics.items()}
    check(launches == tuple(TRAIN_STEPS * n for n in per_step),
          f"{what} train: GRU launches {launches}, expected {per_step} a "
          f"step")
    check(all(np.isfinite(v) for v in losses.values()),
          f"{what} train: non-finite losses {losses}")
    print(f"[{what}] train {cfg.compute_dtype} bs={BATCH}: {step_ms:.1f} ms "
          f"a step ({BATCH / step_ms * 1e3:.1f} img/s) over {TRAIN_STEPS} "
          f"steps, GRU launches {launches}; last losses " + " ".join(
              f"{k}={v:.4f}" for k, v in losses.items()), flush=True)
    return dict(state=state, step=step, gen=gen, batches=batches,
                step_ms=step_ms, launches=launches, losses=losses)


# Phase 10: oldv at 448x64.
def phase_oldv(gru, card: str) -> dict:
    """oldv at full width: serving in bf16 and f32 (img/s, 2 GRU launches a
    chunk, CUDA against CPU), 5 bf16 train steps (ms a step, 2 + 2 GRU
    launches a step), one f32 step CUDA against CPU at B=2 with phase 7's
    limits, and a profiled bf16 step by kernel class."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.serve import InferenceEngine

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

    state, vgg = make_trainer(cfgs["bfloat16"], weights, "cuda")
    run = timed_train_steps(gru, cfgs["bfloat16"], state, vgg, 700, "oldv",
                            (2, 2))
    state, step, gen, batches, step_ms = (
        run[k] for k in ("state", "step", "gen", "batches", "step_ms"))
    result["train"] = {k: run[k] for k in ("step_ms", "launches", "losses")}
    result["profile"] = profile_call(
        lambda: (step(state, vgg, batches[0], gen, 1e-3),
                 torch.cuda.synchronize()),
        f"oldv bf16 train step bs={BATCH}", step_ms)
    del state, vgg, batches, run
    torch.cuda.empty_cache()
    result["cuda_vs_cpu"] = compare_devices(cfgs["float32"], weights,
                                            one_thread=False,
                                            u_atol=OLDV_U_ATOL)
    return result


# Phase 11: vanilla and lr_sh (the plain generator, sbert text) at 448x64.
def phase_vanilla(gru, card: str) -> dict:
    """vanilla at full width: serving through ``InferenceEngine`` in bf16
    and f32 (texts through ``hash_embed``; img/s, a profile, CUDA against
    CPU), 5 bf16 train steps (ms a step, a profile), one f32 step CUDA
    against CPU at B=2, 4 graph replays of the bf16 step against eager
    steps (bit for bit, cudnn.deterministic; a float ``text`` through the
    graph layer), and lr_sh through ``Trainer.fit`` until its plateau
    lowers the rates. The GRU counts are 0 before each path and must read
    0 after it: the plain generator runs no GRU, as in the JAX package."""
    import copy
    import shutil

    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.serve import InferenceEngine
    from vae_gan_mark_tpu_torch.train import build_multi_train_step
    from vae_gan_mark_tpu_torch.train.graphs import CapturedStep
    from vae_gan_mark_tpu_torch.train.loop import Trainer
    from vae_gan_mark_tpu_torch.train.step import make_generator

    cfgs = {name: get_config("vanilla", compute_dtype=name)
            for name in ("bfloat16", "float32")}
    weights = train_weights(cfgs["float32"])
    result = dict(serve={}, launches={})
    requests = make_requests(cfgs["float32"], BATCH, seed=41)
    outs, engines = {}, {}
    for name, cfg in cfgs.items():
        engines[name] = engine = InferenceEngine(cfg, weights[0],
                                                 batch_size=BATCH, seed=0)
        check(engine.device.type == "cuda", "vanilla engine not on the card")
        engine.generate(*requests)
        zero_gru_counts(gru)
        outs[name] = engine.generate(*requests)
        torch.cuda.synchronize()
        result["launches"][f"serve_{name}"] = gru_counts(gru)
        check_patches(outs[name], BATCH, cfg, f"vanilla {name} generate(16)")
        iters = 20
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.generate(*requests)
        dt = time.perf_counter() - t0
        result["serve"][name] = dict(img_per_s=iters * BATCH / dt,
                                     batch_ms=dt / iters * 1e3)
        print(f"[vanilla] serve {name} bs={BATCH}: {iters * BATCH / dt:.1f} "
              f"img/s ({dt / iters * 1e3:.2f} ms a batch) on {card}",
              flush=True)
    serve_launches = result["launches"]
    check(all(v == (0, 0) for v in serve_launches.values()),
          f"vanilla serving launched the GRU: {serve_launches}")
    cpu_out = InferenceEngine(cfgs["float32"], weights[0], batch_size=BATCH,
                              seed=0, device="cpu").generate(*requests)
    device_err = float(np.abs(cpu_out - outs["float32"]).max())
    diff = np.abs(outs["bfloat16"] - outs["float32"])
    print(f"[vanilla] serve CUDA against CPU, float32 (TF32 off): max abs err "
          f"{device_err:.3e} (limit {DEVICE_ATOL}); bf16 against f32 max "
          f"{diff.max():.3e}, mean {diff.mean():.3e}", flush=True)
    check(device_err <= DEVICE_ATOL, f"vanilla CUDA against CPU {device_err}")
    check(diff.max() <= BF16_MAX_ABS and diff.mean() <= BF16_MEAN_ABS,
          f"vanilla bf16 against f32: {diff.max()}, {diff.mean()}")
    result["serve"].update(device_max_abs_err=device_err,
                           bf16_max_abs=float(diff.max()))
    result["serve"]["profile"] = {name: profile_call(
        lambda eng=eng: eng.generate(*requests),
        f"vanilla {name} generate(16)", result["serve"][name]["batch_ms"])
        for name, eng in engines.items()}
    del engines

    cfg = cfgs["bfloat16"]
    state, vgg = make_trainer(cfg, weights, "cuda")
    run = timed_train_steps(gru, cfg, state, vgg, 800, "vanilla", (0, 0))
    state, step, gen, batches, step_ms = (
        run[k] for k in ("state", "step", "gen", "batches", "step_ms"))
    check(batches[0]["text"].dtype == torch.float32,
          "vanilla batches carry float sentence embeddings")
    result["launches"]["train"] = run["launches"]
    result["train"] = {k: run[k] for k in ("step_ms", "losses")}
    result["train"]["profile"] = profile_call(
        lambda: (step(state, vgg, batches[0], gen, 1e-3),
                 torch.cuda.synchronize()),
        f"vanilla bf16 train step bs={BATCH}", step_ms)

    # Graph replays of the bf16 step (a float text input) against eager
    # steps from one state.
    torch.backends.cudnn.deterministic = True
    try:
        # One eager step of the multi step that replays: Adam's state and
        # the signature's warm-up (its graph is captured for the copy
        # below, the state it stays with).
        multi = build_multi_train_step(cfg)
        state, _ = multi(state, vgg, batches[:1], 0, 1e-3)
        saved = copy.deepcopy(state)
        eager, sums_e = copy.deepcopy(saved), None
        for batch in batches[:MULTI_K]:
            eager, m = step(eager, vgg, batch, make_generator(
                "cuda", 0, eager.step), 1e-3)
            sums_e = m if sums_e is None else {k: sums_e[k] + m[k]
                                               for k in sums_e}
        replayed = copy.deepcopy(saved)
        zero_gru_counts(gru)
        replays = []
        replay = CapturedStep.replay
        CapturedStep.replay = lambda self, *a: (replays.append(1),
                                                replay(self, *a))[1]
        try:
            replayed, sums_g = multi(replayed, vgg, batches[:MULTI_K], 0,
                                     1e-3)
        finally:
            CapturedStep.replay = replay
        torch.cuda.synchronize()
        result["launches"]["graph"] = gru_counts(gru)
        state_diff = max_abs_diff(state_tensors(eager),
                                  state_tensors(replayed))
        metric_diff = max(abs(float(sums_e[k]) - float(sums_g[k]))
                          for k in sums_e)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"[vanilla] {MULTI_K} bf16 steps as graph replays against eager "
          f"steps (cuDNN deterministic): state differs by {state_diff:.3e},"
          f" summed metrics by {metric_diff:.3e} (limit 0); GRU launches "
          f"{result['launches']['graph']}", flush=True)
    check(state_diff == 0.0 and metric_diff == 0.0
          and len(replays) == MULTI_K
          and result["launches"]["graph"] == (0, 0),
          f"vanilla replays against eager: {state_diff}, {metric_diff}, "
          f"{len(replays)} replays")
    result["graph"] = dict(state_max_abs_diff=state_diff,
                           metric_max_abs_diff=metric_diff)
    del state, vgg, saved, eager, replayed, batches, run, multi
    torch.cuda.empty_cache()
    result["cuda_vs_cpu"] = compare_devices(cfgs["float32"], weights,
                                            one_thread=False,
                                            u_atol=OLDV_U_ATOL)

    # lr_sh through the epoch driver: plateau patience 0 and a relative
    # threshold of 0.5, so the rates fall after the second epoch.
    lr_cfg = get_config("lr_sh", compute_dtype="bfloat16", batch_size=BATCH,
                        **{"scheduler.patience": 0,
                           "scheduler.threshold": 0.5})
    train = DeviceResidentSynthetic(
        SyntheticPatchDataset(lr_cfg, 4 * BATCH, seed=0), BATCH, 4)
    val = DeviceResidentSynthetic(
        SyntheticPatchDataset(lr_cfg, BATCH, seed=1), BATCH, 1,
        advance_per_epoch=False)
    workdir = os.path.join(RUNS_DIR, "lr_sh")
    shutil.rmtree(workdir, ignore_errors=True)
    zero_gru_counts(gru)
    trainer = Trainer(lr_cfg, train, val, workdir, seed=0,
                      init=weights[:2], vgg_state_dict=weights[2])
    trainer.fit(3)
    torch.cuda.synchronize()
    result["launches"]["lr_sh_fit"] = gru_counts(gru)
    records = read_records(workdir, "lr_sh")
    lrs = [(r["learning_rate/generator"], r["learning_rate/discriminator"])
           for r in records]
    print(f"[vanilla] lr_sh Trainer.fit 3 epochs of 4 steps (bf16, bs "
          f"{BATCH}): val recon " + ", ".join(
              f"{r['val/recon_loss']:.4f}" for r in records)
          + f"; rates (G, D) by epoch {lrs}; GRU launches "
          f"{result['launches']['lr_sh_fit']}", flush=True)
    check(len(lrs) == 3
          and lrs[0] == tuple(float(np.float32(x))
                              for x in (lr_cfg.lr_g, lr_cfg.lr_d))
          and lrs[2][0] < lrs[1][0] and lrs[2][1] < lrs[1][1]
          and result["launches"]["lr_sh_fit"] == (0, 0)
          and all(np.isfinite(r["train/generator_loss"]) for r in records),
          f"lr_sh Trainer: rates {lrs}, {records[-1]}")
    result["lr_sh"] = dict(learning_rates=lrs, records=records)
    shutil.rmtree(workdir, ignore_errors=True)
    del trainer, train, val
    torch.cuda.empty_cache()
    return result


# Phase 12: the projection-conditional D head at 448x64.
def phase_cond_disc(gru, card: str) -> dict:
    """v2 with ``conditional_disc``: 5 bf16 train steps at bs 16 with 2 + 2
    GRU launches a step, and one f32 step at B=2 CUDA against CPU; vanilla
    with it (the ``cond_dense`` branch): one f32 step CUDA against CPU."""
    from vae_gan_mark_tpu_torch.config import get_config

    cfg = get_config("v2", compute_dtype="bfloat16", conditional_disc=True)
    weights = train_weights(get_config("v2", compute_dtype="float32",
                                       conditional_disc=True))
    check(any(k.startswith("cond_embed") for k in weights[1]),
          "conditional v2 D has no cond_embed")
    state, vgg = make_trainer(cfg, weights, "cuda")
    head = {k: v.detach().clone() for k, v in
            state.discriminator.named_parameters() if k.startswith("cond")}
    run = timed_train_steps(gru, cfg, state, vgg, 900, "cond_disc v2",
                            (2, 2))
    state, step_ms, launches, losses = (
        run[k] for k in ("state", "step_ms", "launches", "losses"))
    moved = all(not torch.equal(head[k], p.detach()) for k, p in
                state.discriminator.named_parameters() if k in head)
    print(f"[cond_disc] the head trained: {moved}", flush=True)
    check(moved, "conditional v2 train: the head did not move")
    result = dict(v2_train=dict(step_ms=step_ms, launches=launches,
                                losses=losses))
    del state, vgg, run
    torch.cuda.empty_cache()
    # D's weights after its first Adam update differ by up to lr between
    # the devices where |g| is near Adam's eps (see OLDV_U_ATOL), so u is
    # held to atol lr here too.
    result["v2_cuda_vs_cpu"] = compare_devices(
        get_config("v2", compute_dtype="float32", conditional_disc=True),
        weights, one_thread=False, u_atol=OLDV_U_ATOL)
    vanilla = get_config("vanilla", compute_dtype="float32",
                         conditional_disc=True)
    vanilla_weights = train_weights(vanilla)
    check(any(k.startswith("cond_dense") for k in vanilla_weights[1]),
          "conditional vanilla D has no cond_dense")
    result["vanilla_cuda_vs_cpu"] = compare_devices(
        vanilla, vanilla_weights, one_thread=False, u_atol=OLDV_U_ATOL)
    return result


# Phase 13: data parallelism. Two processes at 8 rows against one at 16,
# float32: the tolerances of tests/test_torch_port_parallel.py (metrics
# rtol 1e-4, BatchNorm running statistics and D's u atol 1e-5), and both
# Adams' first moments per tensor within phase 7's L2 limit (tensors below
# STEP_MOMENT_ZERO of the network's largest, a bias ahead of a norm whose
# gradient is zero in exact arithmetic, as noise below that on both sides).
# Both learning rates are 0, so that every step starts from the same
# parameters on both sides and the comparison holds the step itself:
# Adam's first update, lr * g / (|g| + eps), turns the processes' other sum
# order into parameter steps of up to lr where |g| is near eps, and the
# steps after compound them (a CPU rehearsal of this phase at the tiny
# geometry read 1.4e-3 relative on the third step's gan_g with the
# configured rates). The steps still average both networks' gradients,
# which their moments hold, and move BatchNorm's statistics and u.
DP_STEPS, DP_METRIC_RTOL, DP_BUFFER_ATOL = 3, 1e-4, 1e-5
DP_GROUP_STEPS = 4
# Phase 14: the artifact against the engine, one program and the same
# kernels; cuDNN may pick other algorithms in the program.
EXPORT_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
EXPORT_REQUESTS = 40


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    env.update(extra)
    return env


def dp_run(gru, cfg, weights, batches) -> dict:
    """Train steps on this process's rows of each global batch (all of
    them without a process group), the GRU counts at 0 just before and
    read just after; the metrics, G's and D's buffers and the ms a step."""
    from vae_gan_mark_tpu_torch.parallel import mesh
    from vae_gan_mark_tpu_torch.train import build_train_step
    from vae_gan_mark_tpu_torch.train.step import make_generator

    state, vgg = make_trainer(cfg, weights, "cuda")
    step = build_train_step(cfg)
    local = [mesh.shard_batch(b) for b in batches]
    torch.cuda.synchronize()
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    metrics, times = [], []
    for batch in local:
        t0 = time.perf_counter()
        state, m = step(state, vgg, batch,
                        make_generator(torch.device("cuda"), 7, state.step),
                        1e-3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    moments = {f"{net}.{name}": opt.state[p]["exp_avg"].cpu()
               for net, module, opt in (("G", state.generator, state.opt_g),
                                        ("D", state.discriminator,
                                         state.opt_d))
               for name, p in module.named_parameters()}
    return dict(state=state, metrics=metrics, ms=times, moments=moments,
                launches=(gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches),
                buffers={k: v.cpu() for k, v in watched_buffers(state)
                         .items()})


def dp_moment_spread(ref: dict, runs: list) -> tuple:
    """The largest per-tensor relative L2 difference of the first moments
    in ``runs`` from ``ref``, per network, over tensors above
    STEP_MOMENT_ZERO of that network's largest moment; and the largest of
    the others on either side, relative to that moment."""
    spread, noise = 0.0, 0.0
    for net in ("G.", "D."):
        keys = [k for k in ref if k.startswith(net)]
        top = max(float(ref[k].abs().max()) for k in keys)
        for k in keys:
            if float(ref[k].abs().max()) > STEP_MOMENT_ZERO * top:
                spread = max(spread, max(
                    float((r[k] - ref[k]).norm() / ref[k].norm())
                    for r in runs))
            else:
                noise = max([noise] + [float(t[k].abs().max()) / top
                                       for t in [ref, *runs]])
    return spread, noise


def dp_worker(rank: int, port: int, out_path: str) -> int:
    """One of phase 13's two processes: gloo on the one card (NCCL refuses
    two ranks on one GPU), 8 rows of each 16-row batch, float32."""
    sys.path.insert(0, ROOT)
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.ops import gru
    from vae_gan_mark_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = distributed.initialize(f"localhost:{port}", 2, rank,
                                    backend="gloo", device="cuda")
    cfg = get_config("v2", compute_dtype="float32", lr_g=0.0, lr_d=0.0)
    batches = [train_batch(cfg, BATCH, 300 + i, device)
               for i in range(DP_STEPS)]
    run = dp_run(gru, cfg, train_weights(cfg), batches)
    torch.save(dict(metrics=run["metrics"], ms=run["ms"],
                    launches=run["launches"], buffers=run["buffers"],
                    moments=run["moments"], device=str(device)), out_path)
    distributed.shutdown()
    return 0


def phase_data_parallel(gru, card: str) -> dict:
    """Phase 13: (a) one process in an NCCL group of one against the same
    steps without a group, bf16, bit for bit; (b) two processes on the
    card (gloo) at 8 rows against one process at 16, float32."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.parallel import distributed, mesh

    torch.backends.cudnn.deterministic = True
    try:
        cfg = get_config("v2", compute_dtype="bfloat16")
        weights = train_weights(cfg)
        batches = [train_batch(cfg, BATCH, 200 + i, "cuda")
                   for i in range(DP_GROUP_STEPS)]
        alone = dp_run(gru, cfg, weights, batches)
        distributed.initialize(f"localhost:{free_port()}", 1, 0,
                               device="cuda")
        try:
            check(mesh.active() and torch.distributed.get_backend() == "nccl",
                  "phase 13: no NCCL group of one")
            grouped = dp_run(gru, cfg, weights, batches)
        finally:
            distributed.shutdown()
        a, b = (state_tensors(r["state"]) for r in (alone, grouped))
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(not differ and alone["metrics"] == grouped["metrics"],
              f"phase 13a: a group of one differs from no group: "
              f"{differ[:5]}, metrics {alone['metrics'][-1]} against "
              f"{grouped['metrics'][-1]}")
        steps = DP_GROUP_STEPS
        check(grouped["launches"] == (2 * steps, 2 * steps),
              f"phase 13a: GRU launches {grouped['launches']}, expected "
              f"2 + 2 a step over {steps} steps")
        print(f"[dp] NCCL group of one equals no group over {steps} bf16 "
              f"steps at bs={BATCH}, bit for bit ({len(a)} tensors, "
              f"metrics); GRU launches {grouped['launches']}; ms a step "
              f"{[round(t, 2) for t in grouped['ms']]} (no group "
              f"{[round(t, 2) for t in alone['ms']]})", flush=True)
        del alone, grouped, a, b

        cfg32 = get_config("v2", compute_dtype="float32", lr_g=0.0,
                           lr_d=0.0)
        port = free_port()
        outs = [os.path.join(RUNS_DIR, f"dp_rank{r}.pt") for r in range(2)]
        os.makedirs(RUNS_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker",
             str(r), str(port), outs[r]], cwd=ROOT,
            env=child_env(LOCAL_RANK="0"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=400)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        workers_s = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            check(proc.returncode == 0, f"phase 13b: process {r} exited "
                  f"{proc.returncode}: {log[-3000:]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        for o in outs:
            os.remove(o)
        batches = [train_batch(cfg32, BATCH, 300 + i, "cuda")
                   for i in range(DP_STEPS)]
        one = dp_run(gru, cfg32, train_weights(cfg32), batches)
        metric_rel = max(abs(r["metrics"][i][k] - one["metrics"][i][k])
                         / max(abs(one["metrics"][i][k]), 1e-12)
                         for r in ranks for i in range(DP_STEPS)
                         for k in one["metrics"][i])
        buffer_err = max(float((r["buffers"][k] - v).abs().max())
                         for r in ranks for k, v in one["buffers"].items())
        rank_equal = all(torch.equal(ranks[0]["buffers"][k],
                                     ranks[1]["buffers"][k])
                         for k in one["buffers"])
        moment_l2, moment_noise = dp_moment_spread(
            one["moments"], [r["moments"] for r in ranks])
        print(f"[dp] 2 processes x {BATCH // 2} rows (gloo, one card) vs 1 "
              f"process x {BATCH}, {DP_STEPS} f32 steps: metrics max rel "
              f"{metric_rel:.3e} (limit {DP_METRIC_RTOL}), BN statistics "
              f"and u max abs {buffer_err:.3e} (limit {DP_BUFFER_ATOL}), "
              f"Adam moments per tensor L2 {moment_l2:.3e} (limit "
              f"{STEP_MOMENT_L2}; zero-gradient noise {moment_noise:.3e} of "
              f"the largest, limit {STEP_MOMENT_ZERO}), processes equal "
              f"{rank_equal}; GRU launches "
              f"{[r['launches'] for r in ranks]}; ms a step "
              f"{[[round(t, 2) for t in r['ms']] for r in ranks]} (one "
              f"process {[round(t, 2) for t in one['ms']]}); workers "
              f"{workers_s:.1f} s", flush=True)
        check(rank_equal, "phase 13b: the two processes' buffers differ")
        check(metric_rel <= DP_METRIC_RTOL and buffer_err <= DP_BUFFER_ATOL
              and moment_l2 <= STEP_MOMENT_L2
              and moment_noise <= STEP_MOMENT_ZERO,
              f"phase 13b: 2 processes vs 1: metrics {metric_rel}, "
              f"buffers {buffer_err}, moments {moment_l2}")
        for r in ranks:
            check(tuple(r["launches"]) == (2 * DP_STEPS, 2 * DP_STEPS),
                  f"phase 13b: GRU launches {r['launches']}, expected 2 + 2 "
                  f"a step over {DP_STEPS} steps")
        return dict(group_of_one=dict(steps=DP_GROUP_STEPS,
                                      launches=[2 * DP_GROUP_STEPS] * 2),
                    two_processes=dict(metric_max_rel=metric_rel,
                                       buffer_max_abs=buffer_err,
                                       moment_max_l2=moment_l2,
                                       moment_noise=moment_noise,
                                       launches=[r["launches"]
                                                 for r in ranks],
                                       ms=[r["ms"] for r in ranks],
                                       one_process_ms=one["ms"],
                                       workers_s=workers_s),
                    card=card)
    finally:
        torch.backends.cudnn.deterministic = False


def serve_artifact(art_dir: str, request_path: str, out_path: str) -> int:
    """Phase 14's child: serve an artifact without the model code, the GRU
    counts at 0 before and read after, and time it."""
    sys.path.insert(0, ROOT)
    from vae_gan_mark_tpu_torch.ops import gru
    from vae_gan_mark_tpu_torch.serve.export import ExportedGenerator

    def model_code():
        return sorted(m for m in sys.modules
                      if m.startswith(("vae_gan_mark_tpu_torch.models",
                                       "vae_gan_mark_tpu_torch.train")))

    gen = ExportedGenerator.load(art_dir)
    req = np.load(request_path)
    texts = [str(t) for t in req["texts"]]
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    out = gen.generate(req["ru"], req["mask"], texts, seed=0)
    torch.cuda.synchronize()
    launches = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
    ru, mask, small = req["ru"][:BATCH], req["mask"][:BATCH], texts[:BATCH]
    gen.generate(ru, mask, small)
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        gen.generate(ru, mask, small)       # returns host arrays: synced
    img_per_s = iters * BATCH / (time.perf_counter() - t0)
    np.save(out_path, out)
    print(json.dumps(dict(launches=launches, img_per_s=img_per_s,
                          model_code=model_code())))
    return 0


def phase_export(gru, card: str) -> dict:
    """Phase 14: the v2 generator at 448x64 exported in f32 and bf16 at
    bs 16, each served from a fresh process against the engine."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.models import VAEGANGenerator
    from vae_gan_mark_tpu_torch.serve import InferenceEngine
    from vae_gan_mark_tpu_torch.serve.export import export_generator
    from vae_gan_mark_tpu_torch.utils.port_jax import (
        random_jax_tree, state_dict_from_jax)
    import shutil

    os.makedirs(RUNS_DIR, exist_ok=True)
    result = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("v2", compute_dtype=dtype)
        generator = VAEGANGenerator(cfg)
        generator.load_state_dict(state_dict_from_jax(
            *random_jax_tree(cfg, seed=0), cfg))
        art = os.path.join(RUNS_DIR, f"artifact_{dtype}")
        t0 = time.perf_counter()
        export_generator(cfg, generator, art, batch_size=BATCH)
        export_s = time.perf_counter() - t0
        ru, mask, texts = make_requests(cfg, EXPORT_REQUESTS, seed=40)
        request = os.path.join(RUNS_DIR, f"request_{dtype}.npz")
        np.savez(request, ru=ru, mask=mask, texts=np.array(texts))
        out_path = os.path.join(RUNS_DIR, f"served_{dtype}.npy")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--serve-artifact",
             art, request, out_path], cwd=ROOT, env=child_env(),
            capture_output=True, text=True, timeout=400)
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 14 {dtype}: the artifact's "
              f"process exited {proc.returncode}: {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        check(not child["model_code"], f"phase 14 {dtype}: the artifact's "
              f"process loaded {child['model_code']}")
        chunks = -(-EXPORT_REQUESTS // BATCH)
        check(child["launches"] == [2 * chunks, 0],
              f"phase 14 {dtype}: GRU launches {child['launches']} in the "
              f"artifact's process, expected 2 x {chunks} chunks")
        served = np.load(out_path)
        check_patches(served, EXPORT_REQUESTS, cfg, f"artifact {dtype}")
        engine = InferenceEngine(cfg, generator, batch_size=BATCH, seed=0,
                                 device="cuda")
        want = engine.generate(ru, mask, texts)
        err = float(np.abs(served - want).max())
        check(err <= EXPORT_ATOL[dtype], f"phase 14 {dtype}: artifact vs "
              f"engine max abs {err} > {EXPORT_ATOL[dtype]}")
        small = (ru[:BATCH], mask[:BATCH], texts[:BATCH])
        engine.generate(*small)
        iters = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.generate(*small)
        engine_rate = iters * BATCH / (time.perf_counter() - t0)
        print(f"[export] {dtype}: exported in {export_s:.1f} s; served "
              f"{EXPORT_REQUESTS} requests from a fresh process ({child_s:.1f}"
              f" s, no models/ or train/ module loaded), GRU launches "
              f"{child['launches']} ({chunks} chunks); vs engine max abs "
              f"{err:.3e} (limit {EXPORT_ATOL[dtype]}); bs={BATCH} "
              f"artifact {child['img_per_s']:.1f} img/s, engine "
              f"{engine_rate:.1f} img/s on {card}", flush=True)
        result[dtype] = dict(export_s=export_s, child_s=child_s,
                             launches=child["launches"], chunks=chunks,
                             max_abs_err=err,
                             artifact_img_per_s=child["img_per_s"],
                             engine_img_per_s=engine_rate)
        del generator, engine
        shutil.rmtree(art, ignore_errors=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return result


def phase_doctor() -> dict:
    """``python -m vae_gan_mark_tpu_torch.doctor`` on the card: every
    check ok."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "vae_gan_mark_tpu_torch.doctor"], cwd=ROOT,
                          env=child_env(), capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    for line in lines:
        print(f"[doctor] {line}", flush=True)
    check(proc.returncode == 0 and lines and
          all(ln.startswith("[ok]") for ln in lines),
          f"doctor exited {proc.returncode}: {proc.stdout[-2000:]} "
          f"{proc.stderr[-2000:]}")
    return dict(seconds=seconds, lines=lines)


# Phase 15: the device loader. The dataset of benchmarks/loader_bench.py
# (its defaults: 24 creatives of 1280x720, 8 text quads each, 192 samples)
# in the reference's layout, made from a seed with Pillow; it lives in
# RUNS_DIR (about 200 MB of PNGs, more than OUT_DIR may bring back) and is
# removed at the end of the phase. Device against host loader: mean abs
# per stream < 0.02 (tests/test_device_pipeline.py: cv2's fixed-point warp
# against a float one, plus the bucket's resampling of oversized regions).
LOADER_IMAGES, LOADER_QUADS, LOADER_SIZE = 24, 8, (1280, 720)
LOADER_MEAN_ABS = 0.02
# Phase 16: the model axis. 4 processes (data 2 x model 2) on the one card
# over gloo against one process at the same global batch of 8, float32,
# both learning rates 0 (phase 13's reasons), phase 13b's limits.
TP_PROCESSES, TP_MODEL, TP_BATCH, TP_STEPS = 4, 2, 8, 3
TP_G_PARAMS_PER_RANK = 54.96e6      # tests/test_torch_port_model_axis.py


def write_loader_dataset(root: str) -> dict:
    """benchmarks/loader_bench.py's on-disk dataset: noise creatives (RU,
    EN, mask PNGs) with LOADER_QUADS quads each, from seed 0."""
    from PIL import Image

    rng = np.random.default_rng(0)
    dirs = {k: os.path.join(root, k) for k in ("json", "ru", "en", "mask")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    w, h = LOADER_SIZE
    for i in range(LOADER_IMAGES):
        base = f"img{i:03d}"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(dirs["ru"], base + "_ru.png"))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(dirs["en"], base + "_en.png"))
        Image.fromarray(rng.integers(0, 255, (h, w), np.uint8)).save(
            os.path.join(dirs["mask"], base + "_ru.png"))
        anns = []
        for _ in range(LOADER_QUADS):
            x0 = int(rng.integers(0, w - 500))
            y0 = int(rng.integers(0, h - 120))
            quad = [[x0, y0], [x0 + 460, y0 + 6], [x0 + 452, y0 + 80],
                    [x0 - 4, y0 + 72]]
            anns.append({"bbox_ru": quad, "bbox_en": quad, "text": "Sample"
                         f" {i}-{len(anns)}"})
        with open(os.path.join(dirs["json"], base + ".json"), "w") as f:
            json.dump(anns, f)
    return dirs


def drain_loader(loader, to_card) -> tuple:
    """One epoch of ``loader``, each batch's streams on the card
    (``to_card``), ending in ``synchronize()``: (batches, img/s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = []
    for batch in loader(0):
        batches.append({**batch, **to_card(batch)})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return batches, sum(len(b["raw_text"]) for b in batches) / seconds


def phase_device_loader(gru, card: str) -> dict:
    """Phase 15: ``DeviceWarpLoader(device="cuda")`` against
    ``HostWarpLoader`` on the same samples (v2 448x64, bs 16), both
    loaders' img/s over an epoch, and the train CLI with ``--loader
    device`` for one bf16 epoch at bs 16, K=1 and K=4 (2 + 2 GRU launches
    a train step, 2 a val batch), and its refusal of ``--patch-cache``."""
    import shutil

    from vae_gan_mark_tpu_torch import cli
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.data.device_pipeline import DeviceWarpLoader
    from vae_gan_mark_tpu_torch.data.index import build_index, grouped_split
    from vae_gan_mark_tpu_torch.data.pipeline import HostWarpLoader

    root = os.path.join(RUNS_DIR, "loader")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    dirs = write_loader_dataset(os.path.join(root, "data"))
    write_s = time.perf_counter() - t0
    samples = build_index(dirs["json"], dirs["ru"], dirs["en"], dirs["mask"])
    check(len(samples) == LOADER_IMAGES * LOADER_QUADS,
          f"phase 15: indexed {len(samples)} samples")
    cfg = get_config("v2", compute_dtype="bfloat16", batch_size=BATCH)
    idx = list(range(len(samples)))
    common = dict(batch_size=BATCH, shuffle=False, drop_last=True,
                  num_workers=8)
    device_loader = DeviceWarpLoader(cfg, samples, idx, device="cuda",
                                     **common)
    host_loader = HostWarpLoader(cfg, samples, idx, **common)

    def host_to_card(batch):
        return {k: torch.from_numpy(batch[k]).pin_memory().to(
            "cuda", non_blocking=True) for k in ("ru", "en", "mask")}

    result = dict(samples=len(samples), write_s=write_s, card=card)
    drained = {}
    for name, loader, to_card in (("device", device_loader, dict),
                                  ("host", host_loader, host_to_card)):
        drained[name], rate = drain_loader(loader, to_card)
        result[name] = dict(img_per_s=rate, batches=len(drained[name]))
    dev_b, host_b = drained.pop("device"), drained.pop("host")
    mean_abs = {key: max(float((d[key] - h[key]).abs().mean())
                         for d, h in zip(dev_b, host_b))
                for key in ("ru", "en", "mask")}
    texts_equal = all(d["raw_text"] == h["raw_text"]
                      and np.array_equal(d["text"], h["text"])
                      for d, h in zip(dev_b, host_b))
    on_card = all(d[k].is_cuda for d in dev_b for k in ("ru", "en", "mask"))
    print(f"[loader] {len(samples)} samples of {LOADER_SIZE[0]}x"
          f"{LOADER_SIZE[1]} creatives written in {write_s:.1f} s; device "
          f"loader {result['device']['img_per_s']:.1f} img/s, host loader "
          f"(cv2, to the card) {result['host']['img_per_s']:.1f} img/s at "
          f"bs={BATCH}, 8 workers, on {card}; device vs host mean abs per "
          f"stream {mean_abs} (limit {LOADER_MEAN_ABS}), texts equal "
          f"{texts_equal}", flush=True)
    check(on_card and texts_equal and len(dev_b) == len(host_b)
          and max(mean_abs.values()) < LOADER_MEAN_ABS,
          f"phase 15: device loader vs host loader: {mean_abs}, texts "
          f"equal {texts_equal}, on the card {on_card}")
    result["mean_abs"] = mean_abs
    del dev_b, host_b

    # The loader's warp of one batch of prepared buckets (stacking, the
    # pinned upload and the wait included), and the warp alone on buckets
    # already on the card.
    from vae_gan_mark_tpu_torch.data.device_pipeline import (
        _prep_sample, warp_buckets)
    loaded = [_prep_sample(samples[i]) for i in range(BATCH)]
    result["warp_ms"] = cuda_time_ms(lambda: device_loader.warp(loaded), 10)
    buckets = [torch.from_numpy(np.stack([s[i] for s in loaded])).cuda()
               for i in (0, 1, 2, 3)]
    buckets.append(torch.tensor([s[4] for s in loaded], device="cuda"))
    buckets += [torch.from_numpy(np.stack([s[i] for s in loaded])).cuda()
                for i in (5, 6)]
    result["warp_on_card_ms"] = cuda_time_ms(
        lambda: warp_buckets(cfg, *buckets), 10)
    print(f"[loader] warp of a batch of {BATCH}: {result['warp_ms']:.2f} ms "
          f"with the stacking and the upload, {result['warp_on_card_ms']:.2f}"
          f" ms on buckets already on the card", flush=True)

    train_idx, val_idx = grouped_split(samples, cfg.val_split,
                                       cfg.split_seed)
    steps, val_batches = len(train_idx) // BATCH, -(-len(val_idx) // BATCH)
    args = ["--variant", "v2", "--json-dir", dirs["json"], "--ru-dir",
            dirs["ru"], "--en-dir", dirs["en"], "--mask-dir", dirs["mask"],
            "--batch-size", str(BATCH), "--epochs", "1", "--loader",
            "device", "--set", "compute_dtype=bfloat16"]
    for k in (1, 4):
        workdir = os.path.join(root, f"run_k{k}")
        zero_gru_counts(gru)
        t0 = time.perf_counter()
        cli.main(args + ["--workdir", workdir, "--multi-step", str(k)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = gru_counts(gru)
        record = read_records(workdir)[-1]
        expected = (2 * steps + 2 * val_batches, 2 * steps)
        print(f"[loader] train CLI --loader device --multi-step {k}: 1 "
              f"epoch of {steps} bf16 steps at bs={BATCH} and {val_batches} "
              f"val batches in {seconds:.1f} s (checkpoints included), "
              f"{record['train/images_per_sec']:.1f} img/s through the "
              f"Trainer, loss_G {record['train/generator_loss']:.4f}; GRU "
              f"launches {launches}, expected {expected}", flush=True)
        check(launches == expected,
              f"phase 15 K={k}: GRU launches {launches}, expected {expected}")
        check(np.isfinite(record["train/generator_loss"]),
              f"phase 15 K={k}: non-finite loss {record}")
        result[f"cli_k{k}"] = dict(
            seconds=seconds, launches=launches, steps=steps,
            val_batches=val_batches,
            img_per_s=record["train/images_per_sec"],
            loss_G=record["train/generator_loss"])
    try:
        cli.main(args + ["--workdir", os.path.join(root, "refused"),
                         "--patch-cache", os.path.join(root, "cache")])
        refused = None
    except SystemExit as e:
        refused = e.code
    check(isinstance(refused, str) and "--patch-cache requires --loader "
          "host" in refused,
          f"phase 15: --patch-cache with --loader device: {refused!r}")
    print(f"[loader] --patch-cache with --loader device exits: {refused}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return result


def tp_worker(rank: int, port: int, out_path: str) -> int:
    """One of phase 16's four processes: gloo on the one card, data 2 x
    model 2, v2 at full width, float32, both rates 0, G partitioned at
    kernel_min_ch 512; 4 rows of each global batch of 8. Then the same
    batches at both rates 1e-4 with cuDNN's default algorithms, and a
    digest of each whole parameter."""
    sys.path.insert(0, ROOT)
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.ops import gru
    from vae_gan_mark_tpu_torch.parallel import distributed, mesh
    from vae_gan_mark_tpu_torch.train import build_train_step
    from vae_gan_mark_tpu_torch.train.step import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = distributed.initialize(f"localhost:{port}", TP_PROCESSES, rank,
                                    backend="gloo", device="cuda")
    layout = mesh.make_mesh(TP_MODEL)
    cfg = get_config("v2", compute_dtype="float32", lr_g=0.0, lr_d=0.0)
    batches = [mesh.shard_batch(train_batch(cfg, TP_BATCH, 400 + i, device))
               for i in range(TP_STEPS)]
    state, vgg = make_trainer(cfg, train_weights(cfg), device)
    mesh.replicate_(state.generator)
    mesh.partition_params(state.generator, kernel_min_ch=512)
    g = state.generator
    step = build_train_step(cfg)
    torch.cuda.synchronize()
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    metrics, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, vgg, batch, make_generator(device, 7,
                                                          state.step), 1e-3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
    params = dict(g.named_parameters())
    moments = {f"G.{n}": (opt_m if mesh.sharded_dim(p) is None else
                          mesh.gather_tensor(opt_m, mesh.sharded_dim(p)))
               .cpu() for n, p in params.items()
               for opt_m in [state.opt_g.state[p]["exp_avg"]]}
    moments.update({f"D.{n}": state.opt_d.state[p]["exp_avg"].cpu()
                    for n, p in state.discriminator.named_parameters()})
    blocks = {n: p.detach().cpu() for n, p in params.items()
              if mesh.sharded_dim(p) is not None}
    block_moments_sized = all(
        state.opt_g.state[p][k].shape == p.shape for p in params.values()
        for k in ("exp_avg", "exp_avg_sq"))
    buffers = {k: v.cpu() for k, v in watched_buffers(state).items()}
    # The same batches again at both rates with cuDNN's default algorithms,
    # whose float32 atomics make the model ranks' gradients differ in
    # rounding: their whole parameters must stay equal bit for bit.
    from vae_gan_mark_tpu_torch.train.state import set_lr
    torch.backends.cudnn.deterministic = False
    set_lr(state.opt_g, 1e-4)
    set_lr(state.opt_d, 1e-4)
    drift_metrics = []
    for batch in batches:
        state, m = step(state, vgg, batch, make_generator(device, 7,
                                                          state.step), 1e-3)
        drift_metrics.append({k: float(v) for k, v in m.items()})
    whole = {f"G.{n}": p for n, p in g.named_parameters()
             if mesh.sharded_dim(p) is None}
    whole.update({f"D.{n}": p
                  for n, p in state.discriminator.named_parameters()})
    digests = {k: hashlib.sha1(p.detach().cpu().numpy().tobytes())
               .hexdigest() for k, p in whole.items()}
    torch.save(dict(metrics=metrics, ms=times, launches=launches,
                    drift_metrics=drift_metrics, digests=digests,
                    moments=moments, blocks=blocks, buffers=buffers,
                    block_moments_sized=block_moments_sized,
                    g_parameters=sum(p.numel() for p in g.parameters()),
                    mesh=dict(layout.shape, data_index=layout.data_index,
                              model_index=layout.model_index)), out_path)
    distributed.shutdown()
    return 0


def run_workers(flag: str, count: int, timeout: float) -> tuple:
    """``count`` processes of this script with ``flag RANK PORT OUT``, on
    the one card; their saved results and the seconds they took."""
    port = free_port()
    os.makedirs(RUNS_DIR, exist_ok=True)
    outs = [os.path.join(RUNS_DIR, f"{flag[2:]}_rank{r}.pt")
            for r in range(count)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(port),
         outs[r]], cwd=ROOT, env=child_env(LOCAL_RANK="0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(count)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"{flag} process {r} exited "
              f"{proc.returncode}: {log[-3000:]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    for o in outs:
        os.remove(o)
    return ranks, seconds


def phase_model_axis(gru, card: str) -> dict:
    """Phase 16: 4 processes, data 2 x model 2, against one process at the
    same global batch (v2 full width, f32, rates 0, cudnn.deterministic);
    the model ranks' whole parameters equal bit for bit after steps at
    both rates with cuDNN's default algorithms; then ``python -m
    vae_gan_mark_tpu_torch.parallel.dryrun --processes 4`` at full
    width."""
    from vae_gan_mark_tpu_torch.config import get_config

    ranks, workers_s = run_workers("--tp-worker", TP_PROCESSES, 600)
    torch.backends.cudnn.deterministic = True
    try:
        cfg = get_config("v2", compute_dtype="float32", lr_g=0.0, lr_d=0.0)
        batches = [train_batch(cfg, TP_BATCH, 400 + i, "cuda")
                   for i in range(TP_STEPS)]
        one = dp_run(gru, cfg, train_weights(cfg), batches)
    finally:
        torch.backends.cudnn.deterministic = False
    metric_rel = max(abs(r["metrics"][i][k] - one["metrics"][i][k])
                     / max(abs(one["metrics"][i][k]), 1e-12)
                     for r in ranks for i in range(TP_STEPS)
                     for k in one["metrics"][i])
    buffer_err = max(float((r["buffers"][k] - v).abs().max())
                     for r in ranks for k, v in one["buffers"].items())
    moment_l2, moment_noise = dp_moment_spread(
        one["moments"], [r["moments"] for r in ranks])
    blocks_equal = all(
        torch.equal(ranks[r]["blocks"][k], ranks[r % TP_MODEL]["blocks"][k])
        for r in range(TP_MODEL, TP_PROCESSES) for k in ranks[r]["blocks"])
    held = [r["g_parameters"] for r in ranks]
    whole = sum(v.numel() for k, v in one["moments"].items()
                if k.startswith("G."))
    # The model ranks of a data index after the steps at both rates with
    # cuDNN's default algorithms: their whole parameters, and how far
    # their metrics (averaged over the data group alone) part.
    peers = [(r, r - r % TP_MODEL) for r in range(TP_PROCESSES)
             if r % TP_MODEL]
    whole_equal = all(ranks[r]["digests"] == ranks[q]["digests"]
                      for r, q in peers)
    drift_metric = max(abs(a[k] - b[k]) for r, q in peers
                       for a, b in zip(ranks[r]["drift_metrics"],
                                       ranks[q]["drift_metrics"])
                       for k in a)
    print(f"[tp] {TP_PROCESSES} processes (data {TP_PROCESSES // TP_MODEL} "
          f"x model {TP_MODEL}, gloo, one card) vs 1 process at "
          f"{TP_BATCH} rows, {TP_STEPS} f32 steps: metrics max rel "
          f"{metric_rel:.3e} (limit {DP_METRIC_RTOL}), BN statistics and u "
          f"max abs {buffer_err:.3e} (limit {DP_BUFFER_ATOL}), Adam moments "
          f"per tensor L2 {moment_l2:.3e} (limit {STEP_MOMENT_L2}; "
          f"zero-gradient noise {moment_noise:.3e}, limit "
          f"{STEP_MOMENT_ZERO}), data ranks' blocks equal {blocks_equal}, "
          f"{len(ranks[0]['blocks'])} leaves sharded, G parameters held per "
          f"rank {held} (one process {whole}); GRU launches "
          f"{[r['launches'] for r in ranks]}; ms a step "
          f"{[[round(t, 1) for t in r['ms']] for r in ranks]} (one process "
          f"{[round(t, 1) for t in one['ms']]}); workers {workers_s:.1f} s "
          f"on {card}", flush=True)
    print(f"[tp] {TP_STEPS} more steps at both rates 1e-4 with cuDNN's "
          f"default algorithms: model ranks' whole parameters (G's "
          f"{len(ranks[0]['digests'])} whole leaves with D's) equal bit for "
          f"bit {whole_equal}; their metrics differ by up to "
          f"{drift_metric:.3e}", flush=True)
    check(whole_equal, "phase 16: the model ranks' whole parameters "
          "parted at both rates")
    check(blocks_equal, "phase 16: data ranks hold different blocks")
    check(all(r["block_moments_sized"] for r in ranks),
          "phase 16: an Adam moment is not its parameter's block size")
    check(all(abs(h - TP_G_PARAMS_PER_RANK) < 0.005e6 for h in held),
          f"phase 16: G parameters per rank {held}")
    check(metric_rel <= DP_METRIC_RTOL and buffer_err <= DP_BUFFER_ATOL
          and moment_l2 <= STEP_MOMENT_L2
          and moment_noise <= STEP_MOMENT_ZERO,
          f"phase 16: TP vs 1 process: metrics {metric_rel}, buffers "
          f"{buffer_err}, moments {moment_l2} (noise {moment_noise})")
    for r in ranks:
        check(tuple(r["launches"]) == (2 * TP_STEPS, 2 * TP_STEPS),
              f"phase 16: GRU launches {r['launches']}, expected 2 + 2 a "
              f"step over {TP_STEPS} steps")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vae_gan_mark_tpu_torch.parallel.dryrun",
         "--processes", str(TP_PROCESSES)], cwd=ROOT,
        env=child_env(), capture_output=True, text=True, timeout=600)
    dryrun_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun")]
    for line in lines:
        print(f"[tp] {line}", flush=True)
    check(proc.returncode == 0 and len(lines) == TP_PROCESSES
          and all(" ok: " in ln for ln in lines),
          f"phase 16: the dry run exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    print(f"[tp] dry run of {TP_PROCESSES} processes: {dryrun_s:.1f} s",
          flush=True)
    return dict(metric_max_rel=metric_rel, buffer_max_abs=buffer_err,
                moment_max_l2=moment_l2, moment_noise=moment_noise,
                blocks_equal=blocks_equal, g_parameters=held,
                whole_equal_at_rates=whole_equal,
                model_rank_metric_spread=drift_metric,
                sharded_leaves=len(ranks[0]["blocks"]),
                launches=[r["launches"] for r in ranks],
                ms=[r["ms"] for r in ranks], one_process_ms=one["ms"],
                workers_s=workers_s, dryrun_s=dryrun_s, dryrun=lines,
                card=card)


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
    from vae_gan_mark_tpu_torch.ops import conv_probe, gru, resize

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    build = phase_build([gru.KERNEL, gru.BACKWARD_KERNEL, conv_probe.KERNEL,
                         resize.RESIZE_KERNEL])
    forward = phase_gru_forward(gru)
    backward = phase_gru_backward(gru)
    conv = phase_conv(conv_probe)
    resized = phase_resize(resize)
    serve = phase_serve(gru, card)
    train = phase_train(gru, card)
    driver = phase_epoch_driver(gru, card, train["rates"])
    t_new = time.perf_counter()
    multi = phase_multi_step(gru, card)
    multi_driver = phase_multi_step_driver(gru)
    t_oldv = time.perf_counter()
    oldv = phase_oldv(gru, card)
    t_vanilla = time.perf_counter()
    vanilla = phase_vanilla(gru, card)
    t_cond = time.perf_counter()
    print(f"[done] phase 11 (vanilla, lr_sh) took {t_cond - t_vanilla:.1f} s",
          flush=True)
    cond = phase_cond_disc(gru, card)
    t_dp = time.perf_counter()
    print(f"[done] phase 12 (conditional D) took {t_dp - t_cond:.1f} s",
          flush=True)
    dp = phase_data_parallel(gru, card)
    t_export = time.perf_counter()
    export = phase_export(gru, card)
    t_doctor = time.perf_counter()
    doctor = phase_doctor()
    t_loader = time.perf_counter()
    print(f"[done] phase 13 (data parallel) took {t_export - t_dp:.1f} s, "
          f"phase 14 (export) {t_doctor - t_export:.1f} s, doctor "
          f"{t_loader - t_doctor:.1f} s", flush=True)
    loader = phase_device_loader(gru, card)
    t_tp = time.perf_counter()
    tp = phase_model_axis(gru, card)
    t_end = time.perf_counter()
    print(f"[done] phase 15 (device loader) took {t_tp - t_loader:.1f} s, "
          f"phase 16 (model axis) {t_end - t_tp:.1f} s", flush=True)
    new_phases_s = dict(multi_step=t_oldv - t_new, oldv=t_vanilla - t_oldv,
                        vanilla=t_cond - t_vanilla, cond_disc=t_dp - t_cond,
                        data_parallel=t_export - t_dp,
                        export=t_doctor - t_export,
                        doctor=t_loader - t_doctor,
                        device_loader=t_tp - t_loader,
                        model_axis=t_end - t_tp)
    print(f"[done] phase 9 took {new_phases_s['multi_step']:.1f} s, phase "
          f"10 {new_phases_s['oldv']:.1f} s", flush=True)

    fwd_row, fwd_row_128 = (next(r for r in forward["rows"]
                                 if r["H"] == 256 and r["B"] == b)
                            for b in (BATCH, 128))
    bwd_row = next(r for r in backward["rows"]
                   if r["H"] == 256 and r["B"] == BATCH)
    conv_row = conv["shapes"]["v2_full_res_64ch_f2"]
    resize_row = resized["shapes"]["v2_w448"]
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
                 oldv_train=oldv["train"]["launches"][0],
                 vanilla_serve=vanilla["launches"]["serve_bfloat16"][0],
                 vanilla_train=vanilla["launches"]["train"][0],
                 cond_v2_train=cond["v2_train"]["launches"][0],
                 dp_train=dp["two_processes"]["launches"][0][0],
                 export_serve=export["float32"]["launches"][0],
                 device_loader_train=loader["cli_k1"]["launches"][0],
                 device_loader_train_k4=loader["cli_k4"]["launches"][0],
                 tp_train=tp["launches"][0][0]),
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
                 oldv_train=oldv["train"]["launches"][1],
                 vanilla_serve=vanilla["launches"]["serve_bfloat16"][1],
                 vanilla_train=vanilla["launches"]["train"][1],
                 cond_v2_train=cond["v2_train"]["launches"][1],
                 dp_train=dp["two_processes"]["launches"][0][1],
                 export_serve=export["float32"]["launches"][1],
                 device_loader_train=loader["cli_k1"]["launches"][1],
                 device_loader_train_k4=loader["cli_k4"]["launches"][1],
                 tp_train=tp["launches"][0][1]),
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
        dict(name="upsample_bilinear_forward", route="cuda",
             source="vae_gan_mark_tpu_torch/csrc/resize_bilinear.cu",
             replaces=None,
             launches=train["bfloat16"]["resize_launches"][0],
             launches_by_path=dict(
                 serve=serve["resize_launches"][0],
                 train_bfloat16=train["bfloat16"]["resize_launches"][0],
                 train_float32=train["float32"]["resize_launches"][0],
                 epoch_driver_run_b=driver["run_b"]["resize_launches"][0],
                 serve_from_checkpoint=driver["serve"]["resize_launches"][0],
                 multi_step_graph_8_steps=multi["resize_launches_8_steps"][0],
                 multi_step_run_b=multi_driver["run_b"]["resize_launches"][0],
                 **{f"{v}_{path}": counts[0]
                    for v, by_path in resized["step_launches"].items()
                    for path, counts in by_path.items()}),
             max_ulps=max(r["max_ulps"] for r in resized["shapes"].values()),
             ms=resize_row["ms"], plain_cpu_ms=resize_row["plain_cpu_ms"],
             bound_ms=resize_row["bound_ms"], bound_by="bytes",
             library_ms=resize_row["library_ms"]),
        dict(name="upsample_bilinear_backward", route="cuda",
             source="vae_gan_mark_tpu_torch/csrc/resize_bilinear.cu",
             replaces=None,
             launches=train["bfloat16"]["resize_launches"][1],
             launches_by_path=dict(
                 train_bfloat16=train["bfloat16"]["resize_launches"][1],
                 train_float32=train["float32"]["resize_launches"][1],
                 epoch_driver_run_b=driver["run_b"]["resize_launches"][1],
                 multi_step_graph_8_steps=multi["resize_launches_8_steps"][1],
                 multi_step_run_b=multi_driver["run_b"]["resize_launches"][1],
                 **{f"{v}_{path}": counts[1]
                    for v, by_path in resized["step_launches"].items()
                    for path, counts in by_path.items()}),
             max_grad_rel_err=max(r["grad_rel_err"]
                                  for r in resized["shapes"].values()),
             ms=resize_row["backward_ms"],
             plain_cpu_ms=resize_row["plain_backward_cpu_ms"],
             bound_ms=resize_row["bound_ms"], bound_by="bytes",
             library_ms=resize_row["library_backward_ms"]),
    ]
    seconds = time.perf_counter() - t_start

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, seconds=seconds,
                       build=build, gru_forward=forward,
                       gru_backward=backward, conv=conv, resize=resized,
                       serve=serve,
                       train=train, epoch_driver=driver,
                       multi_step=multi, multi_step_driver=multi_driver,
                       oldv=oldv, vanilla=vanilla, cond_disc=cond,
                       data_parallel=dp, export=export, doctor=doctor,
                       device_loader=loader, model_axis=tp,
                       new_phases_s=new_phases_s,
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
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--serve-artifact"]:
        sys.exit(serve_artifact(*sys.argv[2:5]))
    sys.exit(main())
