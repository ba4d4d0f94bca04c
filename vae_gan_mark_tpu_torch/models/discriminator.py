"""PatchGAN discriminator (the JAX package's ``models/discriminator.py``),
NHWC in, NCHW inside.

Spectral-norm convs k4 s2 p1, 3 -> 64 -> 128 -> 256 -> 512, InstanceNorm
(affine) after stages 2-4, LeakyReLU 0.2, then a plain conv k4 s1 p1 to a
1-channel logit map. It computes in float32 whatever the compute dtype, as
the JAX package's does (its ``PatchDiscriminator`` keeps the default float32
dtype); callers cast the images to the compute dtype first, as the JAX train
step does.

The modules sit in an ``nn.Sequential`` named ``body`` at the reference's
indices (spectral convs 0, 2, 5, 8 with ``weight_orig``, ``bias`` and
``weight_u``; InstanceNorms 3, 6, 9; the final conv 11), so the JAX
package's ``utils/port_torch.py:port_discriminator`` reads its state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.norms import InstanceNorm, SpectralConv


class PatchDiscriminator(nn.Module):
    """(B, H, W, 3) images -> (B, 1, H/16 - 1, W/16 - 1) patch logits,
    float32. Only the reference's unconditional D is ported."""

    def __init__(self, cond_vocab: int = 0):
        super().__init__()
        if cond_vocab:
            raise NotImplementedError(
                "the projection-conditional discriminator head is not "
                "ported yet: ROADMAP 'Modules to port': conditional D head")
        c = 64
        self.body = nn.Sequential(
            SpectralConv(3, c), nn.LeakyReLU(0.2),
            SpectralConv(c, 2 * c), InstanceNorm(2 * c), nn.LeakyReLU(0.2),
            SpectralConv(2 * c, 4 * c), InstanceNorm(4 * c),
            nn.LeakyReLU(0.2),
            SpectralConv(4 * c, 8 * c), InstanceNorm(8 * c),
            nn.LeakyReLU(0.2),
            nn.Conv2d(8 * c, 1, 4, stride=1, padding=1))

    def forward(self, x: torch.Tensor, update_sn: bool = True) -> torch.Tensor:
        """``update_sn`` advances every spectral ``u`` by one power
        iteration (the train step's forwards); the eval step passes
        False."""
        y = x.float().permute(0, 3, 1, 2)
        for layer in self.body:
            y = layer(y, update_sn) if isinstance(layer, SpectralConv) \
                else layer(y)
        return y
