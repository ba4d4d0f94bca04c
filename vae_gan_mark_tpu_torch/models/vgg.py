"""VGG16 ``features[:16]`` (conv1_1 .. relu3_3, two max-pools) for the
perceptual loss, as the JAX package's ``models/vgg.py:VGG16Features``.

Images (B, H, W, 3) in [0, 1] are ImageNet-normalised in float32 inside,
then cast to the compute dtype for the seven 3x3 convs. The network is
frozen: its parameters never take a gradient, which flows through the input
only. Convs sit in an ``nn.Sequential`` named ``net`` at torchvision's
indices (0, 2, 5, 7, 10, 12, 14), so the JAX package's
``utils/port_torch.py:port_vgg_head`` reads its state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.convblocks import (
    Conv2d, max_pool_2x2, nhwc_to_nchw)

# features[:16]: channel widths per conv, "M" = 2x2 max pool.
VGG16_HEAD_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _MaxPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x)


class VGG16Features(nn.Module):
    """NHWC [0, 1] images -> relu3_3 features (B, 256, H/4, W/4) in
    ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers, prev = [], 3
        for c in VGG16_HEAD_CFG:
            if c == "M":
                layers.append(_MaxPool())
            else:
                layers += [Conv2d(prev, c, 3, padding=1, dtype=dtype),
                           nn.ReLU()]
                prev = c
        self.net = nn.Sequential(*layers)
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.float() - self.mean) / self.std
        return self.net(nhwc_to_nchw(x.to(self.dtype)))
