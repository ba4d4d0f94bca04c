"""The seeds of the port's generators (``train/step.py``,
``serve/chunks.py``)."""

import numpy as np


def derive_seed(*keys: int) -> int:
    """A 63-bit seed from a tuple of non-negative integers."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
