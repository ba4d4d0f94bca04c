"""Fixed-size chunks of a serving request, shared by ``InferenceEngine``
and the exported artifact (``serve/export.py``), so both run the generator
on the same padded chunks with the same noise.

A request of N rows goes through in chunks of ``batch_size``; the last one
is padded with zero images and empty texts, and its padding is cut from
the output. The noise of the chunk that starts at request row ``start`` is
drawn on the CPU from a ``torch.Generator`` seeded from ``(seed, start)``
(``utils/seeds.py``; the counterpart of the JAX package's ``fold_in(rng, start)``), so one seed
gives the same noise on every device.

Each chunk's ``encode`` and padding run in a ``serve.encode`` span and its
noise in a ``serve.noise`` span (``utils/profiling.py``); the counters
``serve.rows_requested`` and ``serve.rows_computed`` add up the rows asked
for and the rows the generator runs, padding included.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from vae_gan_mark_tpu_torch.utils.profiling import count, span
from vae_gan_mark_tpu_torch.utils.seeds import derive_seed


def chunk_noise(seed: int, start: int, batch_size: int,
                z_ch: int) -> torch.Tensor:
    """The (batch_size, 1, 1, z_ch) float32 noise of the chunk at
    ``start``, on the CPU."""
    gen = torch.Generator().manual_seed(derive_seed(seed, start))
    return torch.randn((batch_size, 1, 1, z_ch), generator=gen,
                       dtype=torch.float32)


def pad_rows(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """``arr`` as float32 with zero rows appended up to ``batch_size``."""
    arr = np.asarray(arr, np.float32)
    n = arr.shape[0]
    if n == batch_size:
        return arr
    return np.pad(arr, [(0, batch_size - n)] + [(0, 0)] * (arr.ndim - 1))


def generate_in_chunks(run: Callable, encode: Callable[[list], np.ndarray],
                       ru: np.ndarray, mask: np.ndarray,
                       texts: Sequence[str], batch_size: int, seed: int,
                       z_ch: int) -> np.ndarray:
    """``run(ru, mask, text, eps) -> (batch_size, H, W, 3)`` numpy over the
    padded chunks of a request; ``encode`` makes a chunk's ``text`` from
    its strings. Returns the (N, H, W, 3) float32 patches."""
    n = ru.shape[0]
    if n == 0:
        return np.zeros((0,) + tuple(ru.shape[1:3]) + (3,), np.float32)
    texts = list(texts)
    count("serve.rows_requested", n)
    outs = []
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        m = end - start
        with span("serve.encode"):
            text = encode(texts[start:end] + [""] * (batch_size - m))
            ru_c = pad_rows(ru[start:end], batch_size)
            mask_c = pad_rows(mask[start:end], batch_size)
        with span("serve.noise"):
            eps = chunk_noise(seed, start, batch_size, z_ch)
        count("serve.rows_computed", batch_size)
        out = run(ru_c, mask_c, text, eps)
        outs.append(out[:m])
    return np.concatenate(outs, axis=0)
