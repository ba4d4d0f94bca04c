"""VAE encoders (NCHW): the plain stride-2 conv stack (vanilla, lr_sh) and
the U-Net down path (unet, v2, oldv).

Submodule names follow the reference's state-dict keys: ``feat.{0,1,3,4,
...}`` for the plain stack's ``nn.Sequential``; ``e_conv1`` ...
``e_conv4``, ``bottleneck_conv`` for the U-Net; ``mu_head``,
``logvar_head`` for both. The latent heads are convs whose kernel covers
the whole latent grid, VALID (4 x 28 at 448x64): a learned global pooling
to (B, z_ch, 1, 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.convblocks import (
    Conv2d, ConvBNRelu, DoubleConvBlock, max_pool_2x2)


class _LatentHeads(nn.Module):
    """mu/logvar heads: Conv with kernel = full latent extent, VALID.

    Used as a base class so that the heads' keys sit directly under the
    encoder (``mu_head.weight``), as in the reference."""

    def _init_heads(self, in_ch: int, z_ch: int, latent_hw: Tuple[int, int],
                    dtype: torch.dtype) -> None:
        self.mu_head = Conv2d(in_ch, z_ch, latent_hw, dtype=dtype)
        self.logvar_head = Conv2d(in_ch, z_ch, latent_hw, dtype=dtype)

    def heads(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mu_head(h), self.logvar_head(h)


class PlainEncoder(_LatentHeads):
    """[Conv k3 s2 p1 (+bias) + BN + ReLU] per entry of ``chans`` (128, 256,
    512, 1024 for the reference's /16), then the latent heads. Returns
    (mu, logvar, None): it has no skips."""

    def __init__(self, in_ch: int, chans: Sequence[int], z_ch: int,
                 latent_hw: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers: List[nn.Module] = []
        prev = in_ch
        for c in chans:
            layers.extend(ConvBNRelu(prev, c, stride=2, dtype=dtype))
            prev = c
        self.feat = nn.Sequential(*layers)
        self._init_heads(prev, z_ch, latent_hw, dtype)

    def forward(self, x: torch.Tensor):
        mu, logvar = self.heads(self.feat(x))
        return mu, logvar, None


class UNetEncoder(_LatentHeads):
    """U-Net down path: returns (mu, logvar, skips), skips shallow -> deep,
    each at full/2^i resolution with chans[i] channels."""

    def __init__(self, in_ch: int, chans: Sequence[int], bottleneck_ch: int,
                 z_ch: int, latent_hw: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        prev = in_ch
        for i, c in enumerate(chans):
            self.add_module(f"e_conv{i + 1}", DoubleConvBlock(prev, c, dtype))
            prev = c
        self.num_levels = len(chans)
        self.bottleneck_conv = DoubleConvBlock(prev, bottleneck_ch, dtype)
        self._init_heads(bottleneck_ch, z_ch, latent_hw, dtype)

    def forward(self, x: torch.Tensor):
        skips: List[torch.Tensor] = []
        for i in range(self.num_levels):
            x = getattr(self, f"e_conv{i + 1}")(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck_conv(x)
        mu, logvar = self.heads(x)
        return mu, logvar, skips
