"""Small constant tensors that ops build once per device and then reuse.

A few ops need a fixed tensor on their input's device: the adaptive pool's
averaging matrix, the row weights of FiLM's BatchNorm statistics, the
strip-factored FiLM's y-interpolation matrix. Built on every call, each is
a host-to-device copy or a few kernels; a copy from pageable host memory is
also refused while a CUDA graph is being captured. ``device_constant``
builds each one once per (key, device) and keeps it. It builds none during
a capture: a step runs eagerly once on its device before it is captured
(``train/graphs.py``), and that run builds them.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

_CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(key: Hashable, device: torch.device,
                    make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor ``make()`` on ``device``, built at the first call for
    ``(key, device)`` and the same tensor at every later one. Callers must
    not write to it."""
    device = torch.device(device)
    value = _CONSTANTS.get((key, device))
    if value is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the constant {key!r} is first needed on {device} during a "
                "CUDA graph capture; run the step once eagerly before "
                "capturing it")
        value = make().to(device)
        _CONSTANTS[(key, device)] = value
    return value
