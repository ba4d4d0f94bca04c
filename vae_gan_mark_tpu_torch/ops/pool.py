"""Adaptive average pooling with exact torch bin semantics.

``nn.AdaptiveAvgPool1d(out)`` averages input[floor(i*L/out) : ceil((i+1)*L/out)]
per output bin (60 characters -> W/16 = 28 columns at v2). As in the JAX
package the pool is one float32 product with a fixed (L, out) averaging
matrix.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _adaptive_avg_matrix(in_len: int, out_len: int) -> np.ndarray:
    m = np.zeros((in_len, out_len), dtype=np.float32)
    for i in range(out_len):
        start = math.floor(i * in_len / out_len)
        end = math.ceil((i + 1) * in_len / out_len)
        m[start:end, i] = 1.0 / (end - start)
    return m


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """x: (..., L, C) pooled over L to (..., out_len, C), channel-last like
    the JAX function: out[b, o, c] = sum_l M[l, o] * x[b, l, c]."""
    m = torch.from_numpy(_adaptive_avg_matrix(x.shape[-2], out_len)).to(
        x.device)
    y = torch.einsum("...lc,lo->...oc", x.float(), m)
    return y.to(x.dtype)
