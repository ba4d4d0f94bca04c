"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. require CUDA and print the card's name and power limit;
2. build the GRU kernel (``vae_gan_mark_tpu_torch/csrc/gru_fwd.cu``) with
   ``nvcc`` for ``sm_90a`` from the checkout's sources;
3. hold the kernel against its plain PyTorch version at L=60,
   H in {16, 256}, B in {1, 16, 128}, both directions, float32 with TF32
   off, and time the kernel, the plain version, one ``torch.nn.GRU`` call
   (cuDNN) on the same inputs, and the bound;
4. serve the v2 generator at full width (448x64) through
   ``InferenceEngine(device="cuda")`` with seeded random weights: requests
   of 16, 5 and 33 patches and one full-image render, counting GRU kernel
   launches; hold the float32 output against the same engine on the CPU,
   run once in bfloat16, and time img/s at batch 16;
5. print the kernels' JSON line and, last, the device line.

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

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain: the product's sum order differs (per-thread k slices
# summed across threads vs cuBLAS), a few float32 ulps per step over 60
# steps.
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# CUDA vs CPU generator output, both float32 with TF32 off: cuDNN and the
# CPU take different algorithms and sum orders through ~20 conv layers
# (read 5.4e-7 on an H100); TF32 left on would miss this limit.
DEVICE_ATOL = 1e-4
# bfloat16 vs float32 output: bf16 keeps 8 bits of mantissa through every
# conv, so only a loose bound on the outputs in (0, 1) holds.
BF16_MAX_ABS, BF16_MEAN_ABS = 0.05, 0.01

L_TEXT = 60
BATCH = 16


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


def gru_bound(length: int, batch: int, hidden: int):
    flops = 2 * length * batch * hidden * 3 * hidden
    nbytes = 4 * (length * batch * 3 * hidden + length * batch * hidden
                  + 3 * hidden * hidden + 3 * hidden)
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel(gru) -> list:
    """Kernel vs plain vs cuDNN at the GRU shapes of the serving path."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for hidden in (16, 256):
        for batch in (1, 16, 128):
            bound = 1.0 / hidden ** 0.5
            x_proj = torch.randn(L_TEXT, batch, 3 * hidden, device="cuda",
                                 generator=gen)
            w_hh = (torch.rand(3 * hidden, hidden, device="cuda",
                               generator=gen) * 2 - 1) * bound
            b_hh = (torch.rand(3 * hidden, device="cuda",
                               generator=gen) * 2 - 1) * bound
            # cuDNN on the same inputs: an identity input projection makes
            # nn.GRU's x @ W_ih^T + b_ih equal x_proj, so it computes the
            # same function plus one (3H x 3H) product per row.
            lib = torch.nn.GRU(3 * hidden, hidden).cuda()
            with torch.no_grad():
                lib.weight_ih_l0.copy_(torch.eye(3 * hidden))
                lib.bias_ih_l0.zero_()
                lib.weight_hh_l0.copy_(w_hh)
                lib.bias_hh_l0.copy_(b_hh)
            for reverse in (False, True):
                out = gru.gru_recurrence(x_proj, w_hh, b_hh, reverse)
                torch.cuda.synchronize()
                ref = gru.gru_recurrence_plain(x_proj, w_hh, b_hh, reverse)
                err = (out - ref).abs().max().item()
                ok = torch.allclose(out, ref, atol=KERNEL_ATOL,
                                    rtol=KERNEL_RTOL)
                check(ok, f"kernel vs plain H={hidden} B={batch} "
                          f"reverse={reverse}: max abs err {err}")
                with torch.no_grad():
                    lib_in = x_proj.flip(0) if reverse else x_proj
                    lib_out = lib(lib_in)[0]
                    lib_out = lib_out.flip(0) if reverse else lib_out
                lib_err = (lib_out - ref).abs().max().item()
                ms = cuda_time_ms(lambda: gru.gru_recurrence(
                    x_proj, w_hh, b_hh, reverse), 50)
                plain_ms = cuda_time_ms(lambda: gru.gru_recurrence_plain(
                    x_proj, w_hh, b_hh, reverse), 10)
                with torch.no_grad():
                    library_ms = cuda_time_ms(lambda: lib(x_proj), 50)
                bound_ms, bound_by = gru_bound(L_TEXT, batch, hidden)
                row = dict(H=hidden, B=batch, reverse=reverse,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, library_max_abs_err=lib_err,
                           bound_ms=bound_ms, bound_by=bound_by)
                rows.append(row)
                print(f"[kernel] L={L_TEXT} H={hidden:3d} B={batch:3d} "
                      f"reverse={int(reverse)} err={err:.3e} "
                      f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"cudnn_ms={library_ms:.4f} (cudnn err {lib_err:.2e}) "
                      f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    return rows


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


def phase_slice(gru, card: str) -> dict:
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
    print(f"[slice] v2 {cfg.patch_w}x{cfg.patch_h} engine ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    requests = {n: make_requests(cfg, n, seed=n) for n in (16, 5, 33)}
    img_rng = np.random.default_rng(7)
    image = img_rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    mask_image = np.zeros((720, 1280), np.uint8)
    quad = np.array([[300, 200], [900, 230], [890, 330], [290, 300]],
                    np.float32)

    # The main path: counts start at 0 here and are read right after.
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
    check(launches == 4 * chunks,
          f"GRU kernel launches {launches}, expected 4 x {chunks} chunks")
    print(f"[slice] generate 16/5/33 + render: {chunks} chunks, "
          f"{launches} GRU kernel launches", flush=True)

    # Same engine on the CPU with the same seed, hence the same eps.
    cpu_engine = InferenceEngine(cfg, state_dict, batch_size=BATCH, seed=0,
                                 device="cpu")
    cpu_out = cpu_engine.generate(*requests[5])
    device_err = float(np.abs(cpu_out - outs[5]).max())
    check(device_err <= DEVICE_ATOL,
          f"CUDA vs CPU float32 max abs err {device_err} > {DEVICE_ATOL}")
    print(f"[slice] CUDA vs CPU float32 (TF32 off): max abs err "
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
    print(f"[slice] bfloat16 vs float32: max abs {bf16_max:.3e}, mean abs "
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
        print(f"[slice] {name} generate bs={BATCH}: "
              f"{throughput[name]:.1f} img/s ({dt / iters * 1e3:.2f} ms "
              f"per batch) on {card}", flush=True)

    profile = profile_generate(engines, requests[16], batch_ms)
    return dict(launches=launches, chunks=chunks, device_max_abs_err=device_err,
                bf16_max_abs=bf16_max, bf16_mean_abs=bf16_mean,
                img_per_s=throughput, profile=profile)


KERNEL_CLASSES = (  # first match wins; matched against the kernel's name
    ("gru kernel", ("gru_fwd_kernel",)),
    ("upsample", ("upsample",)),
    ("convolution", ("conv", "implicit_gemm", "xmma", "fft", "winograd",
                     "pointwise_mult_and_sum_complex", "dgrad",
                     "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul", ("gemm", "gemv", "splitK")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
)


def kernel_class(name: str) -> str:
    for cls, needles in KERNEL_CLASSES:
        if any(n in name for n in needles):
            return cls
    return "other elementwise / reduction"


def profile_generate(engines, request, batch_ms) -> dict:
    """Device time by kernel class for one generate(16) per precision. The
    idle share is 1 - busy / the wall time of that same profiled call, which
    includes the profiler's own host work; device time above the wall time
    would be a double count and fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    result = {}
    for name, eng in engines.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(*request)          # returns host arrays: synced
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies, memsets): a CPU op's
        # own row repeats the device time of the kernels it launched.
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        check(busy_ms <= wall_ms * 1.01,
              f"profile of {name} generate(16): device busy {busy_ms:.2f} ms "
              f"exceeds the call's wall time {wall_ms:.2f} ms")
        classes = {}
        for e in events:
            cls = kernel_class(e.key)
            ms, count = classes.get(cls, (0.0, 0))
            classes[cls] = (ms + e.self_device_time_total / 1e3,
                            count + e.count)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        result[name] = dict(
            batch_ms=batch_ms[name], profiled_wall_ms=wall_ms,
            device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
            classes=classes,
            top=[(e.key[:100], e.self_device_time_total / 1e3, e.count)
                 for e in top])
        print(f"[profile] {name} generate(16): {wall_ms:.2f} ms profiled "
              f"({batch_ms[name]:.2f} ms unprofiled), device busy "
              f"{busy_ms:.2f} ms, idle share "
              f"{result[name]['idle_share']:.3f}", flush=True)
        for cls, (ms, count) in sorted(classes.items(), key=lambda i: -i[1][0]):
            print(f"[profile]   {ms:8.3f} ms  {count:4d} launches  {cls}",
                  flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vae_gan_mark_tpu_torch.ops import gru

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path, log = gru.build()
    print(f"[build] {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    kernel_rows = phase_kernel(gru)
    slice_result = phase_slice(gru, card)

    main_row = next(r for r in kernel_rows
                    if r["H"] == 256 and r["B"] == BATCH and not r["reverse"])
    kernels = [dict(
        name="gru_forward", route="cuda",
        source="vae_gan_mark_tpu_torch/csrc/gru_fwd.cu",
        replaces="vae_gan_mark_tpu/ops/pallas/gru.py:76",
        launches=slice_result["launches"],
        max_abs_err=max(r["max_abs_err"] for r in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       kernel_rows=kernel_rows, slice=slice_result,
                       kernels=kernels), f, indent=1)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
