"""The one generator of serving traffic, driven by a traffic file's
parameters.

A closed loop of one client sends requests one after another. Request
sizes come in cycles of ``cycle`` requests: each cycle holds the same sizes
(the quantiles at (i + 0.5) / cycle of the size distribution) in an order
shuffled from the seed, so every seed serves the same work in another
order. ``sizes`` is ``{"dist": "geometric", "p": .., "min": .., "max": ..}``
(truncated to [min, max]) or ``{"dist": "fixed", "value": ..}``. A request
of n patches takes rows [offset, offset + n) of a seeded pool of
``pool_patches`` patches and n target strings of its own.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np


class Request(NamedTuple):
    index: int
    offset: int
    size: int
    texts: List[str]


def cycle_sizes(spec: dict, cycle: int) -> np.ndarray:
    if spec["dist"] == "fixed":
        return np.full(cycle, int(spec["value"]), np.int64)
    if spec["dist"] != "geometric":
        raise ValueError(f"size distribution {spec['dist']!r}")
    ks = np.arange(spec["min"], spec["max"] + 1)
    pmf = spec["p"] * (1.0 - spec["p"]) ** (ks - 1)
    cdf = np.cumsum(pmf / pmf.sum())
    qs = (np.arange(cycle) + 0.5) / cycle
    return ks[np.minimum(np.searchsorted(cdf, qs), len(ks) - 1)]


def requests(traffic: dict, alphabet: str, max_len: int,
             seed: int) -> Iterator[Request]:
    """Requests without end, the same sequence for the same seed."""
    rng = np.random.default_rng(seed)
    sizes = cycle_sizes(traffic["sizes"], traffic["cycle"])
    chars = np.array(list(alphabet))
    lo, hi = traffic["text_len"]
    pool = traffic["pool_patches"]
    index = 0
    while True:
        for size in rng.permutation(sizes):
            size = int(size)
            lengths = rng.integers(lo, min(hi, max_len) + 1, size)
            texts = ["".join(rng.choice(chars, int(k))) for k in lengths]
            yield Request(index, int(rng.integers(0, pool - size + 1)), size,
                          texts)
            index += 1
