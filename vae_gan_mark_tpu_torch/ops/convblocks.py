"""Convolution building blocks (NCHW), each computing in a compute dtype.

Parameters stay float32; a block casts its input and weights to the compute
dtype where the JAX package's ``nn.Conv(dtype=...)`` does. The JAX
``LanePaddedConv`` pads a 64->3 conv's output channels to 8 TPU lanes with
identical math, so here it is a plain ``Conv2d``.

A conv whose weight ``parallel/mesh.py:partition_params`` has cut to this
model rank's output channels computes them alone and gathers the rest
(``mesh.column_parallel``).

Blocks are ``nn.Sequential``s so that their state-dict keys follow the
reference's ``[Conv, BN, ReLU, Conv, BN, ReLU]`` indices (``0.weight``,
``1.running_mean``, ``3.weight``, ...).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vae_gan_mark_tpu_torch.ops.norms import BatchNorm
from vae_gan_mark_tpu_torch.parallel.mesh import column_parallel

_Pair = Union[int, Tuple[int, int]]


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as NCHW: a view on the card (the convolutions there run
    channels-last), a copy in NCHW memory on the CPU, whose convolutions on
    a channels-last view computed D's weight gradients 2.6e-2 off float64
    (oneDNN on a Xeon CPU with AMX; tests/test_torch_port_cond_disc.py)."""
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=2, stride=2)."""
    return F.max_pool2d(x, 2, 2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` run in ``dtype`` (input, weight and bias cast)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: _Pair,
                 padding: _Pair = 0, stride: _Pair = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return column_parallel(
            lambda x, w, b: self._conv_forward(x.to(dt), w.to(dt), b), x,
            self.weight, bias)


class TConv(nn.ConvTranspose2d):
    """Bare ConvTranspose2d run in ``dtype``.

    torch's symmetric ``padding=p`` gives out = (in - 1) * s + k - 2p, the
    shape the JAX package reaches with lax padding (k - 1 - p) on each side
    and a spatially flipped kernel (the weight bridge does the flip).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: _Pair,
                 stride: _Pair = 1, padding: _Pair = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return column_parallel(
            lambda x, w, b: F.conv_transpose2d(
                x.to(dt), w.to(dt), b, self.stride, self.padding), x,
            self.weight, self.bias.to(dt))


class ConvBNRelu(nn.Sequential):
    """Conv (+bias) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: _Pair = 3,
                 stride: _Pair = 1, padding: _Pair = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            Conv2d(in_ch, out_ch, kernel_size, padding=padding,
                   stride=stride, bias=bias, dtype=dtype),
            BatchNorm(out_ch, dtype=dtype),
            nn.ReLU())


class DoubleConvBlock(nn.Sequential):
    """[Conv k3 p1 bias=False + BN + ReLU] x 2 -- the U-Net conv block."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            *ConvBNRelu(in_ch, out_ch, bias=False, dtype=dtype),
            *ConvBNRelu(out_ch, out_ch, bias=False, dtype=dtype))


class TConvBNRelu(nn.Sequential):
    """ConvTranspose -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: _Pair,
                 stride: _Pair = 1, padding: _Pair = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            TConv(in_ch, out_ch, kernel_size, stride, padding, dtype=dtype),
            BatchNorm(out_ch, dtype=dtype),
            nn.ReLU())
