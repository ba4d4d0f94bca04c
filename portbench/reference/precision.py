"""How the reference computes: in float32 (the plain reference), or one
precision below what the configuration states (the control).

The configuration states bfloat16 for the generator's and the VGG head's
convolutions and float32 with TF32 off for the discriminator and the GRU.
``Precision`` holds one ``Rounding`` for each of the two groups; every
convolution and matrix product of the reference rounds its two operands
with its group's (``rounding(t)``, the gradient passing unchanged) and its
output (``rounding.out(y)``: the value as the group stores it, and the
gradient that reaches it, so the backward products take rounded operands
too), and accumulates in float32. The plain reference rounds nothing. The
control computes the bfloat16 group in float8, e4m3 for operands and
stored activations and e5m2 for gradients (each under a per-tensor scale
to the format's largest value, as an fp8 training path would), and the
float32 group in TF32 (10 mantissa bits) for operands and gradients.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _straight_through(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return t + (q - t).detach()


def _fp8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    with torch.no_grad():
        scale = largest / t.abs().amax().clamp(min=1e-30)
        return (t * scale).to(dtype).float() / scale


def e4m3(t: torch.Tensor) -> torch.Tensor:
    return _fp8(t, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(t: torch.Tensor) -> torch.Tensor:
    return _fp8(t, torch.float8_e5m2, E5M2_MAX)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits (nearest, ties away)."""
    with torch.no_grad():
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, fn):
        ctx.fn = fn
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


class Rounding:
    """One group's rounding of operands, of stored outputs and of the
    gradients that reach the outputs; None rounds nothing."""

    def __init__(self, operand=None, output=None, grad=None):
        self.operand, self.output, self.grad = operand, output, grad

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.operand is None:
            return t
        return _straight_through(t, self.operand(t.detach()))

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.output is not None:
            y = _straight_through(y, self.output(y.detach()))
        if self.grad is not None and y.requires_grad:
            y = _RoundGrad.apply(y, self.grad)
        return y


class Precision:
    """``low`` rounds the bfloat16 group's products, ``f32`` the float32
    group's."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "control"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        if name == "control":
            self.low = Rounding(e4m3, e4m3, e5m2)
            self.f32 = Rounding(tf32, None, tf32)
        else:
            self.low = self.f32 = Rounding()
