"""Plain reference of what every configuration shares: the building blocks
of a generator (convolutions and linear layers computed through a precision
group's rounding, BatchNorm), the PatchGAN discriminator under spectral
normalisation, and the VGG16 head of the perceptual loss.

It follows the published scripts (Andrey1408/vae-gan-mark) in plain torch
operations: NCHW, float32, no fused shortcuts. Parameter and buffer names
are the scripts' state-dict keys, so one state dict loads here and into the
program under test. Each generator lives in the reference module that its
configuration names (``reference/<module>.py``, see ``__init__.py``).

Each convolution and matrix product rounds its operands through
``precision.Precision``: nothing in float32, one precision lower in the
control. Configurations are the JSON dicts of ``portbench/configs``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reference.precision import Precision, Rounding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_HEAD = (64, 64, "M", 128, 128, "M", 256, 256, 256)

# Init kinds read by the weight maker: "fan_in" U(-1/sqrt(fan_in), ...) as
# torch's default for convolutions and linear layers, "gru" U(-1/sqrt(H),
# ...), "normal" N(0, 1), "fan_out_normal" N(0, 2/fan_out) (torchvision's
# VGG), "one", "zero", "const" and "unit_normal" (a normalised N(0, I)).


def param(shape, init: str, fan: float = 1.0, value: float = 0.0):
    p = nn.Parameter(torch.empty(shape))
    p.init = (init, fan, value)
    return p


def buffer(module: nn.Module, name: str, shape, init: str, fan=1.0,
           value=0.0) -> None:
    module.register_buffer(name, torch.empty(shape))
    getattr(module, name).init = (init, fan, value)


class Conv(nn.Module):
    """A convolution (``transpose`` for ConvTranspose2d, ``dims`` 1 for
    Conv1d) computed through a precision group's ``Rounding``."""

    def __init__(self, cin: int, cout: int, k, bias: bool = True,
                 transpose: bool = False, dims: int = 2):
        super().__init__()
        k = (k,) * dims if isinstance(k, int) else tuple(k)
        shape = (cin, cout) + k if transpose else (cout, cin) + k
        fan_in = shape[1] * math.prod(k)
        self.weight = param(shape, "fan_in", fan_in)
        self.bias = param((cout,), "fan_in", fan_in) if bias else None
        self.transpose = transpose
        self.dims = dims

    def forward(self, x, q: Rounding, stride=1, padding=0):
        w = q(self.weight)
        x = q(x)
        if self.transpose:
            y = F.conv_transpose2d(x, w, self.bias, stride, padding)
        elif self.dims == 1:
            y = F.conv1d(x, w, self.bias, stride, padding)
        else:
            y = F.conv2d(x, w, self.bias, stride, padding)
        return q.out(y)


class BatchNorm(nn.Module):
    """BatchNorm2d: batch statistics (biased variance) in train mode, the
    running ones (moved by 0.1, unbiased variance) in eval mode."""

    momentum = 0.1

    def __init__(self, c: int):
        super().__init__()
        self.weight = param((c,), "one")
        self.bias = param((c,), "zero")
        buffer(self, "running_mean", (c,), "zero")
        buffer(self, "running_var", (c,), "one")

    def forward(self, x):
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * n / (n - 1))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


def seq(*mods) -> nn.Module:
    """A container whose children sit at the scripts' Sequential indices:
    ``(index, module)`` pairs."""
    m = nn.Module()
    for i, mod in mods:
        m.add_module(str(i), mod)
    return m


def latent_hw(cfg: dict):
    """The encoder's output grid: the patch halved once per level."""
    d = 2 ** len(cfg["enc_chans"])
    return cfg["patch_h"] // d, cfg["patch_w"] // d


class Linear(nn.Module):
    """A linear layer computed through a precision group's ``Rounding``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = param((cout, cin), "fan_in", cin)
        self.bias = param((cout,), "fan_in", cin)

    def forward(self, x, q: Rounding):
        return q.out(q(x) @ q(self.weight).t() + self.bias)


class Setting:
    """A context that sets ``owner.<name>`` to ``value`` for its duration
    and restores it after (with no owner it sets nothing): a reference's
    ``counted``, which makes a module compute as the program does for the
    work count."""

    def __init__(self, owner=None, name: str = "", value=None):
        self.owner, self.name, self.value = owner, name, value
        self.saved = None

    def __enter__(self):
        if self.owner is not None:
            self.saved = getattr(self.owner, self.name)
            setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        if self.owner is not None:
            setattr(self.owner, self.name, self.saved)
        return False


class SpectralConv(nn.Module):
    """Conv2d k4 s2 p1 under spectral norm, one power iteration a forward
    (``update``) with ``u`` kept as ``weight_u``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight_orig = param((cout, cin, 4, 4), "fan_in", cin * 16)
        self.bias = param((cout,), "fan_in", cin * 16)
        buffer(self, "weight_u", (cout,), "unit_normal")

    def forward(self, x, q, update: bool):
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        with torch.no_grad():
            v = w.t() @ self.weight_u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            if update:
                u = w @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
                self.weight_u.copy_(u)
            u = self.weight_u.clone()
        sigma = torch.dot(u, w @ v)
        return q.out(F.conv2d(q(x), q(self.weight_orig / sigma), self.bias,
                              2, 1))


class InstanceNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = param((c,), "one")
        self.bias = param((c,), "zero")

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True,
                                   unbiased=False)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class Discriminator(nn.Module):
    """(B, H, W, 3) -> (B, 1, H/16 - 1, W/16 - 1) patch logits."""

    def __init__(self):
        super().__init__()
        self.prec = Precision("float32")
        self.body = seq((0, SpectralConv(3, 64)), (2, SpectralConv(64, 128)),
                        (3, InstanceNorm(128)), (5, SpectralConv(128, 256)),
                        (6, InstanceNorm(256)), (8, SpectralConv(256, 512)),
                        (9, InstanceNorm(512)), (11, Conv(512, 1, 4)))

    def forward(self, x, update: bool = True):
        m, q = self.body._modules, self.prec.f32
        y = x.permute(0, 3, 1, 2)
        y = F.leaky_relu(m["0"](y, q, update), 0.2)
        for conv, norm in (("2", "3"), ("5", "6"), ("8", "9")):
            y = F.leaky_relu(m[norm](m[conv](y, q, update)), 0.2)
        return m["11"](y, q, stride=1, padding=1)


class VGGHead(nn.Module):
    """VGG16 features[:16] (relu3_3) of ImageNet-normalised NHWC images."""

    def __init__(self):
        super().__init__()
        self.prec = Precision("float32")
        net, prev, idx = nn.Module(), 3, 0
        self.plan: List = []
        for c in VGG_HEAD:
            if c == "M":
                self.plan.append("M")
                idx += 1
                continue
            conv = Conv(prev, c, 3)
            conv.weight.init = ("fan_out_normal", c * 9, 0.0)
            conv.bias.init = ("zero", 1.0, 0.0)
            net.add_module(str(idx), conv)
            self.plan.append(str(idx))
            prev, idx = c, idx + 2
        self.net = net
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x):
        y = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        for step in self.plan:
            if step == "M":
                y = F.max_pool2d(y, 2, 2)
            else:
                y = F.relu(self.net._modules[step](y, self.prec.low,
                                                    padding=1))
        return y


def set_precision(modules: Sequence[nn.Module], name: str) -> None:
    for m in modules:
        m.prec = Precision(name)
