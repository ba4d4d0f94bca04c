"""Profiling helpers (the JAX package's ``utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace of its block (the host, and
the card's kernels when it is given a CUDA device) and writes it as a
Chrome trace; ``StepTimer`` measures a step function's steady-state time,
with ``torch.cuda.synchronize`` as the barrier on the card (PyTorch returns
before the card has run the work).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace",
          device: Optional[Union[str, torch.device]] = None):
    """Profile the block and write ``log_dir/name.trace.json``; the card's
    kernels are recorded when ``device`` is a CUDA device. Yields the
    profiler (``key_averages()`` sums the recorded events)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.trace.json"))


class StepTimer:
    """Seconds per call of a step function after ``warmup`` calls, with a
    barrier on ``device`` before the clock starts and before it stops: a
    CUDA device synchronises, the CPU needs none."""

    def __init__(self, warmup: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        self.warmup = warmup
        self.device = torch.device(device)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, step_fn, *args, steps: int = 10, **kwargs) -> float:
        for _ in range(self.warmup):
            step_fn(*args, **kwargs)
        self.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(*args, **kwargs)
        self.barrier()
        return (time.perf_counter() - t0) / steps
