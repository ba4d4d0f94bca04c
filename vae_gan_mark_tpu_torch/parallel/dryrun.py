"""The multi-process dry run (the JAX package's
``__graft_entry__.dryrun_multichip``): one train step of v2 over a
(data, model) mesh of N processes.

    python -m vae_gan_mark_tpu_torch.parallel.dryrun --processes N \\
        [--device cpu] [--tiny]

It starts N processes. They join one process group over TCP on localhost:
NCCL when the host has N cards (one each), gloo otherwise (gloo on the CPU,
or N processes sharing fewer cards: NCCL refuses two ranks on one GPU).
With N even the mesh is (N / 2, 2), else (N, 1). Each process builds v2
from the port's seeded init (``init_state_dicts``), replicates it,
partitions the generator's widest kernels over the ``model`` axis
(``partition_params``, ``kernel_min_ch`` 512, or 64 with ``--tiny``),
takes its data index's rows of a synthetic global batch of 8, runs one
float32 train step, checks that every metric is finite and prints one
line with the mesh, the seconds and the metrics. The run uses the card
unless ``--device cpu`` is given, and fails without one.

Without ``--tiny`` the model is the real v2 at 448x64 with every
production width; ``--tiny`` takes the JAX dry run's tiny widths (the
patch 32x64, ``enc_chans=(8,16,24,64)``, ``bottleneck_ch=64``) with a
global batch of max(8, 2 x data). Unlike the JAX package's emulation of N
devices on one CPU, nothing of the spatial extent is cut.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TINY = dict(patch_h=32, patch_w=64, compute_dtype="float32",
            enc_chans=(8, 16, 24, 64), bottleneck_ch=64, z_ch=16,
            char_emb_dim=16, char_rnn_hidden=16, max_text_len=12)


# Seconds the processes of a run may take in all (the real v2 on one card
# over gloo takes under a minute).
TIMEOUT_S = 500.0


def model_parallel_for(processes: int) -> int:
    return 2 if processes % 2 == 0 else 1


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dryrun_pass(processes: int, rank: int, port: int, device: str,
                tiny: bool) -> None:
    """One process of the dry run: join, partition, one train step, check
    the metrics finite, print them with the mesh and the seconds."""
    from vae_gan_mark_tpu_torch.config import get_config
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.models import VGG16Features
    from vae_gan_mark_tpu_torch.parallel import distributed, mesh
    from vae_gan_mark_tpu_torch.train import (
        batch_to_device, build_train_step, create_train_state)
    from vae_gan_mark_tpu_torch.train.state import (
        init_state_dicts, vgg_state_dict)
    from vae_gan_mark_tpu_torch.train.step import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = None
    if device == "cpu":     # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // processes))
    else:
        backend = ("nccl" if torch.cuda.device_count() >= processes
                   else "gloo")
    dev = distributed.initialize(f"localhost:{port}", processes, rank,
                                 backend=backend, device=device)
    try:
        m = mesh.make_mesh(model_parallel_for(processes))
        if tiny:
            batch_size, kernel_min_ch = max(8, 2 * m.data), 64
            cfg = get_config("v2", batch_size=batch_size, **TINY)
            tag = "tiny"
        else:
            batch_size, kernel_min_ch = 8, 512
            cfg = get_config("v2", compute_dtype="float32",
                             batch_size=batch_size)
            tag = f"real-widths[{cfg.patch_h}x{cfg.patch_w}]"
        ds = SyntheticPatchDataset(cfg, num_samples=batch_size, seed=0)
        batch = mesh.shard_batch(batch_to_device(ds.batch(batch_size, 0),
                                                 dev))
        g_sd, d_sd = init_state_dicts(cfg, 0)
        state = create_train_state(cfg, g_sd, d_sd, dev)
        mesh.replicate_(state.generator)
        mesh.replicate_(state.discriminator)
        mesh.partition_params(state.generator, kernel_min_ch=kernel_min_ch)
        vgg = VGG16Features()
        vgg.load_state_dict(vgg_state_dict())
        vgg.to(dev)
        t0 = time.perf_counter()
        state, metrics = build_train_step(cfg)(
            state, vgg, batch, make_generator(dev, 1, 0), 1e-4)
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        for k, v in metrics.items():
            if not np.isfinite(v):
                raise FloatingPointError(f"dry run {tag}: {k} = {v}")
        params = dict(state.generator.named_parameters())
        held = sum(p.numel() for p in params.values())
        whole = sum(v.numel() for k, v in mesh.gather_params(
            state.generator).items() if k in params)
        print(f"dryrun {tag} ok: process {rank}/{processes} "
              f"mesh={m.shape} backend={torch.distributed.get_backend()} "
              f"G parameters held {held} of {whole} step {seconds:.1f}s "
              f"metrics={metrics}", flush=True)
    finally:
        distributed.shutdown()


def dryrun(processes: int, device: str = "cuda", tiny: bool = False) -> int:
    """Start the processes, wait for them; the exit code (0 when every
    process passed; the others are stopped when one fails, and all after
    ``TIMEOUT_S``). Each process's output goes to this process's, in rank
    order, once they have all ended."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the dry run on the CPU")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    cmd = [sys.executable, "-m", "vae_gan_mark_tpu_torch.parallel.dryrun",
           "--processes", str(processes), "--device", device]
    cmd += ["--tiny"] if tiny else []
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    logs = [tempfile.TemporaryFile() for _ in range(processes)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r), "--port", str(port)],
                              cwd=root, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    # Wait until every process has ended, one has failed (the others would
    # wait for it in a collective) or the time is up; then stop the rest.
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while (any(proc.poll() is None for proc in procs)
               and not any(proc.poll() for proc in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.seek(0)
            sys.stdout.write(log.read().decode(errors="replace"))
            log.close()
        sys.stdout.flush()
    failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        print(f"dryrun: processes {failed} failed or were stopped",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vae_gan_mark_tpu_torch.parallel.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--processes", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default; fails without one) or "
                        "on the CPU")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny widths instead of the real v2")
    # One process of the run (started by the run itself).
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        dryrun_pass(args.processes, args.rank, args.port, args.device,
                    args.tiny)
        return 0
    return dryrun(args.processes, args.device, args.tiny)


if __name__ == "__main__":
    sys.exit(main())
