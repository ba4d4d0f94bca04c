"""Debug guards (the JAX package's ``utils/debug.py``).

``enable_nan_debugging()`` is the reference's
``torch.autograd.set_detect_anomaly(True)``: a backward that makes a NaN
raises at the op that made it. The Trainer's NaN guard (``train/loop.py``)
is the cheap check that is always on; this is the slow one to turn on when
the guard trips (``--debug-nans``).
"""

from __future__ import annotations

import torch


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
