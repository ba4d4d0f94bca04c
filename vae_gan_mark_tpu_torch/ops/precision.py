"""Precision policy.

``compute_dtype="float32"`` is the parity mode: every float32 convolution
and matrix product runs in true float32. On the card that means TF32 off for
both cuBLAS and cuDNN (cuDNN convolutions default to TF32).
``compute_dtype="bfloat16"`` casts convolution inputs and weights to bf16,
where the JAX package casts them; BatchNorm statistics, the GRU and the
generator's outputs stay float32.
"""

from __future__ import annotations

import contextlib

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute_dtype {name!r}")
    return dtypes[name]


@contextlib.contextmanager
def precision_scope(dtype: torch.dtype):
    """Inside, float32 work is true float32 when ``dtype`` is float32.

    The TF32 switches are process-wide, so they are set on entry and put
    back on exit rather than left changed for other callers."""
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
