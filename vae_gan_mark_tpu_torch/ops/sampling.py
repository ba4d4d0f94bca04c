"""VAE reparameterisation."""

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
