"""Loss functions with the reference's semantics (the JAX package's
``losses/__init__.py``), each reduced in float32. The KL term's mean form is
``ops.sampling.kl_divergence``."""

from __future__ import annotations

import torch

from vae_gan_mark_tpu_torch.models.vgg import VGG16Features
from vae_gan_mark_tpu_torch.ops.sampling import kl_divergence  # noqa: F401


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.L1Loss(): mean absolute error."""
    return torch.mean(torch.abs(pred.float() - target.float()))


def hinge_d_real(preds: torch.Tensor) -> torch.Tensor:
    """relu(1 - p).mean(): the discriminator on real images."""
    return torch.mean(torch.relu(1.0 - preds.float()))


def hinge_d_fake(preds: torch.Tensor) -> torch.Tensor:
    """relu(1 + p).mean(): the discriminator on generated images."""
    return torch.mean(torch.relu(1.0 + preds.float()))


def hinge_g(preds: torch.Tensor) -> torch.Tensor:
    """-p.mean(): the generator's adversarial term."""
    return -torch.mean(preds.float())


def perceptual_loss(vgg: VGG16Features, fake: torch.Tensor,
                    real: torch.Tensor) -> torch.Tensor:
    """L1 between the VGG16 relu3_3 features of ``fake`` and ``real``.

    VGG is frozen and ``real`` takes no gradient, so its features are
    computed without a graph; the gradient flows through ``fake`` only."""
    with torch.no_grad():
        target = vgg(real)
    return l1_loss(vgg(fake), target)
