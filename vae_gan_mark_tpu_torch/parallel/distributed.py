"""Multi-process execution (the JAX package's ``parallel/distributed.py``).

One process per card. ``initialize`` joins the processes into a
``torch.distributed`` process group over TCP, as
``jax.distributed.initialize`` joins them into one runtime; the train step
then computes global-batch means (``parallel/mesh.py``), so an N-process
run equals one process with the same global batch. Each process loads only
its rows (``process_local_slice``); the model ranks of one data index
(``mesh.make_mesh(model_parallel)``) load the same rows.

The backend is NCCL for processes on the card and gloo on the CPU (gloo
also takes CUDA tensors, through the host: two processes on one card
cannot share NCCL). A process takes ``cuda:LOCAL_RANK``.

The GRU kernels keep host state for one device in each process
(``ops/cuda_build.py:CudaKernel.claim``): a process that meets a second
card raises, so a run has one process per card.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from vae_gan_mark_tpu_torch.parallel.mesh import (
    active, local_rows, process_count, process_index, reset_mesh)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group and return this process's device.

    The arguments fall back to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` (and ``LOCAL_RANK`` for the
    card). With neither a coordinator nor a process count it does nothing
    (one process without a group) and returns ``device``; a coordinator
    with one process makes a group of one, whose collectives run. On the
    card the process takes ``cuda:LOCAL_RANK`` (default: its rank modulo
    the cards of the host); ``backend`` defaults to NCCL there and to gloo
    on the CPU."""
    device = torch.device(device)
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return device
    if coordinator_address is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "host:port (--coordinator or MASTER_ADDR)")
    num_processes = 1 if num_processes is None else num_processes
    if process_id is None:
        if num_processes > 1:
            raise ValueError("each process of a multi-process run needs "
                             "its --process-id (or RANK)")
        process_id = 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to run the processes on the CPU")
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = process_id % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return device


def shutdown() -> None:
    """Leave the process group, if this process is in one, and forget its
    mesh."""
    reset_mesh()
    if active():
        dist.destroy_process_group()


def process_local_slice(global_batch_size: int) -> slice:
    """The rows of the global batch this process loads: contiguous equal
    blocks in data-index order (``parallel/mesh.py:local_rows``)."""
    return local_rows(global_batch_size)


__all__ = ["initialize", "shutdown", "process_local_slice", "process_count",
           "process_index"]
