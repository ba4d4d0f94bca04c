"""BatchNorm with torch ``BatchNorm2d`` semantics, evaluation mode.

Normalises with the running statistics (eps 1e-5) in float32 whatever the
input type, and returns the compute dtype, as the JAX package's ``BatchNorm``
does. Parameters and buffers carry ``BatchNorm2d``'s names (``weight``,
``bias``, ``running_mean``, ``running_var``). Training mode (batch statistics
and the running update) belongs to the training slice and raises here.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Per-channel BN over dim 1 of an (N, C, ...) tensor."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm train mode comes with the training slice "
                "(ROADMAP: modules to port, training)")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        return y.to(self.dtype)
