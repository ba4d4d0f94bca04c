"""Single-direction and stacked bidirectional GRUs (torch ``nn.GRU``
semantics, gate order r, z, n).

The input projection for every step is hoisted out of the recurrence into
one float32 product (L*B, E) @ (E, 3H), as the JAX package leaves it to XLA
outside its Pallas call; the recurrence goes through ``ops.gru``'s autograd
functions: the Hopper kernels (forward and backward) for a CUDA tensor, their
plain versions for a CPU tensor. The reverse direction runs right to left
and returns outputs in input order. A BiGRU layer runs both directions
through one function, whose forward and backward are each one kernel launch
for the pair.
A weight that ``parallel/mesh.py:partition_params`` has cut to this model
rank's block is gathered whole before the projection and the kernels
(``mesh.gather_at_use``).
Parameters carry ``nn.GRU``'s names (``weight_ih_l0``, ``bias_hh_l1_reverse``
...), so a reference ``state_dict`` loads as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.gru import (bigru_recurrence_grad,
                                            gru_recurrence_grad)
from vae_gan_mark_tpu_torch.parallel.mesh import gather_at_use, global_rows


def input_projection(x_tm: torch.Tensor, w_ih: torch.Tensor,
                     b_ih: torch.Tensor) -> torch.Tensor:
    """Time-major (L, B, E) -> x @ W_ih^T + b_ih (L, B, 3H), float32."""
    length, batch, in_dim = x_tm.shape
    x_proj = torch.addmm(b_ih, x_tm.reshape(length * batch, in_dim).float(),
                         w_ih.t())
    return x_proj.view(length, batch, -1)


def gru_layer(x_tm: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
              w_hh: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool) -> torch.Tensor:
    """Time-major (L, B, E) -> (L, B, H) hidden states, float32."""
    return gru_recurrence_grad(input_projection(x_tm, w_ih, b_ih), w_hh, b_hh,
                               reverse)


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
        out = gru_layer(x.transpose(0, 1), gather_at_use(self.weight_ih_l0),
                        self.bias_ih_l0, gather_at_use(self.weight_hh_l0),
                        self.bias_hh_l0, self.reverse)
        return out.transpose(0, 1).to(x.dtype)


class BiGRU(nn.Module):
    """Stacked bidirectional GRU: (B, L, E) -> (B, L, 2*hidden) in ``dtype``.

    Dropout (rate ``dropout``) applies between layers in train mode only,
    like torch's inter-layer dropout. Its mask is drawn from the
    ``generator`` passed to ``forward``, never from torch's global RNG."""

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

    def _direction(self, y: torch.Tensor, suffix: str):
        """(x_proj, W_hh, b_hh) of one direction of a layer."""
        return (input_projection(
                    y, gather_at_use(getattr(self, f"weight_ih_{suffix}")),
                    getattr(self, f"bias_ih_{suffix}")),
                gather_at_use(getattr(self, f"weight_hh_{suffix}")),
                getattr(self, f"bias_hh_{suffix}"))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x.transpose(0, 1)                       # time-major (L, B, E)
        for layer in range(self.num_layers):
            y = torch.cat(bigru_recurrence_grad(
                *self._direction(y, f"l{layer}"),
                *self._direction(y, f"l{layer}_reverse")), dim=-1)
            if layer + 1 < self.num_layers and self.dropout > 0.0 \
                    and self.training:
                y = y * dropout_mask(y, self.dropout, generator)
        return y.transpose(0, 1).to(self.dtype)


def dropout_mask(y: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep-mask scaled by 1/(1 - rate), drawn from ``generator`` (which
    lives on ``y``'s device). ``y`` is time-major (L, B, C); in a process
    group the mask is drawn for the global batch and this process's rows
    are taken (``parallel/mesh.py:global_rows``)."""
    if generator is None:
        raise ValueError("train-mode dropout draws from an explicit "
                         "torch.Generator; pass generator=")
    keep = 1.0 - rate
    mask = global_rows(lambda shape: y.new_empty(shape).bernoulli_(
        keep, generator=generator), y.shape, dim=1)
    return mask / keep
