"""Single-direction and stacked bidirectional GRUs (torch ``nn.GRU``
semantics, gate order r, z, n).

The input projection for every step is hoisted out of the recurrence into
one float32 product (L*B, E) @ (E, 3H), as the JAX package leaves it to XLA
outside its Pallas call; the recurrence goes through ``ops.gru``: the
Hopper kernel for a CUDA tensor, its plain version for a CPU tensor. The
reverse direction runs right to left and returns outputs in input order.
Parameters carry ``nn.GRU``'s names (``weight_ih_l0``, ``bias_hh_l1_reverse``
...), so a reference ``state_dict`` loads as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vae_gan_mark_tpu_torch.ops.gru import gru_recurrence


def gru_layer(x_tm: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
              w_hh: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool) -> torch.Tensor:
    """Time-major (L, B, E) -> (L, B, H) hidden states, float32."""
    length, batch, in_dim = x_tm.shape
    x_proj = torch.addmm(b_ih, x_tm.reshape(length * batch, in_dim).float(),
                         w_ih.t())
    return gru_recurrence(x_proj.view(length, batch, -1), w_hh, b_hh, reverse)


def _gru_params(module: nn.Module, suffix: str, in_dim: int,
                hidden: int) -> None:
    """Register ``nn.GRU``-named parameters, initialised as torch does:
    uniform(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hidden)
    for name, shape in ((f"weight_ih_{suffix}", (3 * hidden, in_dim)),
                        (f"weight_hh_{suffix}", (3 * hidden, hidden)),
                        (f"bias_ih_{suffix}", (3 * hidden,)),
                        (f"bias_hh_{suffix}", (3 * hidden,))):
        module.register_parameter(
            name, nn.Parameter(torch.empty(shape).uniform_(-bound, bound)))


class GRULayer(nn.Module):
    """Single-direction GRU: (B, L, E) -> (B, L, H), parameters named as a
    one-layer ``nn.GRU``'s."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        _gru_params(self, "l0", in_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = gru_layer(x.transpose(0, 1), self.weight_ih_l0,
                        self.bias_ih_l0, self.weight_hh_l0, self.bias_hh_l0,
                        self.reverse)
        return out.transpose(0, 1).to(x.dtype)


class BiGRU(nn.Module):
    """Stacked bidirectional GRU: (B, L, E) -> (B, L, 2*hidden) in ``dtype``.

    Dropout (rate ``dropout``) applies between layers in train mode only,
    like torch's inter-layer dropout."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 2,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        for layer in range(num_layers):
            layer_in = in_dim if layer == 0 else 2 * hidden
            _gru_params(self, f"l{layer}", layer_in, hidden)
            _gru_params(self, f"l{layer}_reverse", layer_in, hidden)

    def _direction(self, y: torch.Tensor, suffix: str,
                   reverse: bool) -> torch.Tensor:
        return gru_layer(y, getattr(self, f"weight_ih_{suffix}"),
                         getattr(self, f"bias_ih_{suffix}"),
                         getattr(self, f"weight_hh_{suffix}"),
                         getattr(self, f"bias_hh_{suffix}"), reverse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(0, 1)                       # time-major (L, B, E)
        for layer in range(self.num_layers):
            y = torch.cat([self._direction(y, f"l{layer}", False),
                           self._direction(y, f"l{layer}_reverse", True)],
                          dim=-1)
            if layer + 1 < self.num_layers and self.dropout > 0.0:
                y = F.dropout(y, self.dropout, training=self.training)
        return y.transpose(0, 1).to(self.dtype)
