"""VAE reparameterisation and the KL term."""

from __future__ import annotations

from typing import Optional

import torch

from vae_gan_mark_tpu_torch.parallel.mesh import global_rows


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """z = mu + exp(0.5 * logvar) * eps, in float32.

    ``eps`` is the noise, of mu's shape; when None it is drawn N(0, I) in
    float32 from ``generator``, which must live on mu's device. In a
    process group it is drawn at the global batch's shape and this
    process's rows are taken (``parallel/mesh.py:global_rows``)."""
    mu = mu.float()
    if eps is None:
        eps = global_rows(lambda shape: torch.randn(
            shape, generator=generator, device=mu.device,
            dtype=torch.float32), mu.shape)
    return mu + eps.to(mu.device, torch.float32) * torch.exp(
        0.5 * logvar.float())


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """The reference's mean-form KL, in float32:
    -0.5 * mean over the non-batch dims of (1 + logvar - mu^2 - exp(logvar)),
    then the batch mean (a mean, not a sum: the scale matters for the loss).
    """
    mu, logvar = mu.float(), logvar.float()
    per_sample = -0.5 * torch.mean(1.0 + logvar - mu.square() - logvar.exp(),
                                   dim=tuple(range(1, mu.dim())))
    return per_sample.mean()
