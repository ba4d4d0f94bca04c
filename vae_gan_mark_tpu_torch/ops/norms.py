"""Normalisation layers with the reference's (torch default) semantics, as
the JAX package implements them (``ops/norms.py``).

* ``BatchNorm``: ``BatchNorm2d`` (eps 1e-5, momentum 0.1). Train mode
  normalises with the batch's biased variance and moves the running
  statistics by ``running = 0.9 running + 0.1 batch``, the variance there
  unbiased (n / (n - 1)). Eval mode normalises with the running statistics.
  Statistics are float32 whatever the input type; the output is the compute
  dtype. Parameters and buffers carry ``BatchNorm2d``'s names. Inside
  ``running_stats_frozen()`` a train-mode forward normalises as usual and
  leaves the running statistics alone: the encoder's recompute under
  ``remat_encoder`` (``models/vaegan.py``) runs there, so the statistics
  move once per step, as under flax's ``nn.remat``.
* ``InstanceNorm``: ``InstanceNorm2d(affine=True)``, per sample and channel
  over (H, W), biased variance, no running statistics.
* ``spectral_normalize`` / ``SpectralConv``: ``torch.nn.utils.spectral_norm``
  with one power iteration per forward. The iteration runs without
  gradient; the gradient flows through ``sigma = u^T W v``. ``u`` is a
  buffer (``weight_u``) that advances only on a forward with
  ``update_sn=True``. Vectors are normalised as ``v / (||v|| + 1e-12)``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vae_gan_mark_tpu_torch.ops.constants import device_constant

# Per thread: a recompute runs in the thread that runs the backward.
_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Train-mode ``BatchNorm`` forwards in this thread leave their running
    statistics as they are."""
    saved = getattr(_FROZEN, "active", False)
    _FROZEN.active = True
    try:
        yield
    finally:
        _FROZEN.active = saved


def _channel_view(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.dim() - 2))


class BatchNorm(nn.Module):
    """Per-channel BN over dim 1 of an (N, C, ...) tensor."""

    MOMENTUM = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                row_weights: Optional[Sequence[float]] = None
                ) -> torch.Tensor:
        """``row_weights`` (train mode only) weights the statistics along
        dim 2: row i of ``x`` stands for ``row_weights[i]`` rows of a map
        that is not materialised (the row-factored SpatialFiLM)."""
        xf = x.float()
        if self.training:
            mean, var, n = _batch_stats(xf, row_weights)
            if not getattr(_FROZEN, "active", False):
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.mul_(1.0 - m).add_(m * mean)
                    self.running_var.mul_(1.0 - m).add_(
                        m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - _channel_view(x, mean)) * _channel_view(x, inv) \
            + _channel_view(x, self.bias)
        return y.to(self.dtype)


def _batch_stats(xf: torch.Tensor, row_weights: Optional[Sequence[float]]
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel mean, biased variance and count over every dim but 1."""
    dims = (0,) + tuple(range(2, xf.dim()))
    if row_weights is None:
        var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
        return mean, var, xf.numel() // xf.shape[1]
    shape = (1, 1, len(row_weights)) + (1,) * (xf.dim() - 3)
    w = device_constant(
        ("batch_norm_row_weights", tuple(row_weights), shape), xf.device,
        lambda: torch.tensor(row_weights, dtype=torch.float32).view(shape))
    n = round(xf.numel() // (xf.shape[1] * xf.shape[2]) * sum(row_weights))
    mean = (xf * w).sum(dims) / n
    var = ((xf - _channel_view(xf, mean)).square() * w).sum(dims) / n
    return mean, var, n


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) over (H, W) of an (N, C, H, W) tensor,
    float32 out."""

    EPS = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True,
                                   unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.EPS)
        return y * _channel_view(x, self.weight) + _channel_view(x, self.bias)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor,
                       update: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step and the normalised weight.

    ``weight`` is a conv weight (out, in, kh, kw), viewed as (out, in*kh*kw)
    as torch's spectral norm does. Returns (weight / sigma, u'), where u' is
    the advanced ``u`` when ``update`` and ``u`` itself otherwise."""
    w = weight.float().reshape(weight.shape[0], -1)
    with torch.no_grad():
        if update:
            v = _l2_normalize(w.t() @ u)
            u_new = _l2_normalize(w @ v)
        else:
            u_new = u.clone()
            v = _l2_normalize(w.t() @ u)
    sigma = torch.dot(u_new, w @ v)
    return weight / sigma.to(weight.dtype), u_new


class SpectralConv(nn.Module):
    """The discriminator's Conv2d k4 s2 p1 under spectral normalisation,
    float32, with the reference's state-dict names: ``weight_orig``
    (out, in, 4, 4), ``bias`` and the power-iteration buffer ``weight_u``
    (out,). ``u`` starts as the normalised all-ones vector; the weight
    bridge loads a trained or seeded one."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.empty(out_ch, in_ch, 4, 4))
        nn.init.kaiming_uniform_(self.weight_orig, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("weight_u",
                             torch.full((out_ch,), out_ch ** -0.5))

    def forward(self, x: torch.Tensor, update_sn: bool = True) -> torch.Tensor:
        w_sn, u_new = spectral_normalize(self.weight_orig, self.weight_u,
                                         update_sn)
        if update_sn:
            with torch.no_grad():
                self.weight_u.copy_(u_new)
        return F.conv2d(x.float(), w_sn, self.bias, stride=2, padding=1)
