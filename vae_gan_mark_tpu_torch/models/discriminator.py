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

``cond_vocab > 0`` adds the opt-in projection-conditional head (the
reference has none): the text ``cond`` goes to 64 values, by
``cond_embed`` (an ``Embedding(cond_vocab, 64)`` of int tokens, averaged
over all L tokens, PAD included, as in JAX) or, with ``cond_dim > 0``, by
``cond_dense`` (a ``Linear(cond_dim, 64)`` of float sentence embeddings);
``cond_proj`` (``Linear(64, 512, bias=False)``) projects that, and its
inner product with the spatial mean of the 512-channel features that go
into the final conv is added to every logit. Flax creates only the branch
that the input's type reaches, so the port builds only that one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.convblocks import nhwc_to_nchw
from vae_gan_mark_tpu_torch.ops.norms import InstanceNorm, SpectralConv

COND_CH = 64


class PatchDiscriminator(nn.Module):
    """(B, H, W, 3) images (and, with the head, ``cond``: (B, L) tokens or
    (B, cond_dim) embeddings) -> (B, 1, H/16 - 1, W/16 - 1) patch logits,
    float32."""

    def __init__(self, cond_vocab: int = 0, cond_dim: int = 0):
        super().__init__()
        c = 64
        self.body = nn.Sequential(
            SpectralConv(3, c), nn.LeakyReLU(0.2),
            SpectralConv(c, 2 * c), InstanceNorm(2 * c), nn.LeakyReLU(0.2),
            SpectralConv(2 * c, 4 * c), InstanceNorm(4 * c),
            nn.LeakyReLU(0.2),
            SpectralConv(4 * c, 8 * c), InstanceNorm(8 * c),
            nn.LeakyReLU(0.2),
            nn.Conv2d(8 * c, 1, 4, stride=1, padding=1))
        self.conditional = bool(cond_vocab)
        if self.conditional:
            if cond_dim:
                self.cond_dense = nn.Linear(cond_dim, COND_CH)
            else:
                self.cond_embed = nn.Embedding(cond_vocab, COND_CH)
            self.cond_proj = nn.Linear(COND_CH, 8 * c, bias=False)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                update_sn: bool = True) -> torch.Tensor:
        """``update_sn`` advances every spectral ``u`` by one power
        iteration (the train step's forwards); the eval step passes
        False. ``cond`` is read only by a conditional D."""
        y = nhwc_to_nchw(x.float())
        for layer in self.body[:-1]:
            y = layer(y, update_sn) if isinstance(layer, SpectralConv) \
                else layer(y)
        logits = self.body[-1](y)
        if not self.conditional or cond is None:
            return logits
        if cond.is_floating_point():
            e = self.cond_dense(cond.float())
        else:
            e = self.cond_embed(cond).mean(dim=1)
        proj = self.cond_proj(e)
        pooled = y.mean(dim=(2, 3))
        return logits + (pooled * proj).sum(dim=1)[:, None, None, None]
