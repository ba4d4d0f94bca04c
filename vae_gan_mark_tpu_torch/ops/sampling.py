"""VAE reparameterisation and the KL term."""

from __future__ import annotations

from typing import Optional

import torch


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """z = mu + exp(0.5 * logvar) * eps, in float32.

    ``eps`` is the noise, of mu's shape; when None it is drawn N(0, I) in
    float32 from ``generator``, which must live on mu's device."""
    mu = mu.float()
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=torch.float32)
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
