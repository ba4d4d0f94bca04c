"""Decoders (NCHW): the plain conv-transpose stack (vanilla, lr_sh) and the
U-Net-style decoder.

``PlainDecoder`` keeps the reference's ``decode`` ``nn.Sequential``
indices: [ConvTranspose, BN, ReLU] per width at 0, 1 / 3, 4 / ..., then the
k3 conv to RGB and the sigmoid (15, 16 with five widths).

``UNetStyleDecoder`` has SpatialFiLM at every stage (v2, oldv) or none
(unet), and oldv's gated skips. Submodule names follow the reference's
state-dict keys (``bottleneck_proc``,
``up_tconv{n}``, ``spatial_film{n}``, ``conv_block{n}``,
``final_image_conv``; ``skip_gates.{i}``, where i = 0 is the deepest);
stage n = 1 is the deepest.

Bottleneck: z is broadcast across the latent width, the text map is resized
to (1, latent_w) unless it already has that shape (it has at v2; oldv's
height-4 map of W/16 columns goes to 1 row of W/8), both are concatenated
channel-wise, and a ConvTranspose with kernel (latent_h, 1) lifts the
(1, latent_w) strip to the full latent grid. FiLM takes the text map as it
is at every stage.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.convblocks import (
    Conv2d, DoubleConvBlock, TConv, TConvBNRelu)
from vae_gan_mark_tpu_torch.ops.film import GatedSkip, SpatialFiLM
from vae_gan_mark_tpu_torch.ops.resize import interpolate_bilinear


class PlainDecoder(nn.Module):
    """(B, in_ch, 1, 1) -> (B, out_ch, H, W) in (0, 1), in ``dtype``: a
    ConvTranspose whose kernel is the full latent extent (latent_h,
    latent_w), stride 1, padding 0 (the inverse of the encoder's heads),
    then k4 s2 p1 ConvTransposes through ``chans[1:]``, each with BN and
    ReLU, a k3 p1 conv to ``out_ch`` and a sigmoid."""

    def __init__(self, in_ch: int, latent_h: int, latent_w: int,
                 chans: Sequence[int], out_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = list(TConvBNRelu(in_ch, chans[0], (latent_h, latent_w),
                                  dtype=dtype))
        for prev, c in zip(chans, chans[1:]):
            layers.extend(TConvBNRelu(prev, c, 4, stride=2, padding=1,
                                      dtype=dtype))
        layers += [Conv2d(chans[-1], out_ch, 3, padding=1, dtype=dtype),
                   nn.Sigmoid()]
        self.decode = nn.Sequential(*layers)

    def forward(self, zc: torch.Tensor) -> torch.Tensor:
        return self.decode(zc)


class UNetStyleDecoder(nn.Module):
    """Inputs: z (B, z_ch, 1, 1); text_map (B, text_ch, h_t, w_t); skips
    shallow -> deep from ``UNetEncoder``. Output (B, out_ch, H, W) in
    (0, 1), in ``dtype``."""

    def __init__(self, latent_h: int, latent_w: int, z_ch: int, text_ch: int,
                 skip_chans: Sequence[int], bottleneck_ch: int = 1024,
                 out_ch: int = 3, use_film: bool = True,
                 gated_skips: bool = False, fast_film: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_w = latent_w
        self.num_levels = len(skip_chans)
        self.use_film = use_film
        self.skip_gates = nn.ModuleList(
            [GatedSkip(c) for c in reversed(skip_chans)]) if gated_skips \
            else None
        self.bottleneck_proc = TConvBNRelu(
            z_ch + text_ch, bottleneck_ch, (latent_h, 1), dtype=dtype)
        prev = bottleneck_ch
        for i, c in enumerate(reversed(skip_chans)):
            n = i + 1
            self.add_module(f"up_tconv{n}", TConv(prev, c, 2, stride=2,
                                                  dtype=dtype))
            if use_film:
                self.add_module(f"spatial_film{n}", SpatialFiLM(
                    2 * c, text_ch, fast=fast_film, dtype=dtype))
            self.add_module(f"conv_block{n}", DoubleConvBlock(2 * c, c, dtype))
            prev = c
        self.final_image_conv = Conv2d(prev, out_ch, 1, dtype=dtype)

    def forward(self, z: torch.Tensor, text_map: torch.Tensor,
                skips: Sequence[torch.Tensor]) -> torch.Tensor:
        b = z.shape[0]
        z_strip = z.expand(b, z.shape[1], 1, self.latent_w)
        t_strip = interpolate_bilinear(text_map, 1, self.latent_w)
        x = torch.cat([z_strip, t_strip.to(z_strip.dtype)], dim=1)
        x = self.bottleneck_proc(x)
        for i in range(self.num_levels):
            n = i + 1
            skip = skips[self.num_levels - 1 - i]          # deep -> shallow
            x = getattr(self, f"up_tconv{n}")(x)
            if self.skip_gates is not None:
                skip = self.skip_gates[i](skip)
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
            if self.use_film:
                x = getattr(self, f"spatial_film{n}")(x, text_map)
            x = getattr(self, f"conv_block{n}")(x)
        return torch.sigmoid(self.final_image_conv(x))
