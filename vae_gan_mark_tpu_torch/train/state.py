"""Training state: the generator and the discriminator (with their buffers:
G's BatchNorm running statistics, D's spectral ``u``), two Adam optimizers
and the step count. The JAX package's counterpart is ``train/state.py``.

The reference keeps two Adam optimizers with betas (0.5, 0.999) and eps
1e-8. ``torch.optim.Adam`` computes optax's update,
``lr * m_hat / (sqrt(v_hat) + eps)``. G's gradient is clipped to the global
norm ``cfg.grad_clip_norm`` before its Adam step (``clip_by_global_norm_``);
D's is not clipped. Learning rates can change between steps
(``get_lr`` / ``set_lr``), as the plateau schedule does between epochs.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Union

import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.discriminator import PatchDiscriminator
from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator


def make_g_optimizer(cfg: VariantConfig,
                     params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr_g,
                            betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)


def make_d_optimizer(cfg: VariantConfig,
                     params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr_d,
                            betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient times
    ``max_norm / ||g||`` when the global norm ``||g|| >= max_norm``, else
    unchanged. (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (||g|| + 1e-6)``, another function.) Returns ``||g||``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


class TrainState:
    """Everything a train step reads and writes. The modules hold their
    buffers; the step updates modules and optimizers in place."""

    def __init__(self, cfg: VariantConfig, generator: VAEGANGenerator,
                 discriminator: PatchDiscriminator):
        self.generator = generator
        self.discriminator = discriminator
        self.opt_g = make_g_optimizer(cfg, generator.parameters())
        self.opt_d = make_d_optimizer(cfg, discriminator.parameters())
        self.step = 0


def create_train_state(
        cfg: VariantConfig, g_state_dict: Mapping[str, torch.Tensor],
        d_state_dict: Mapping[str, torch.Tensor],
        device: Union[str, torch.device] = "cuda") -> TrainState:
    """G and D from their state dicts (``utils/port_jax.py`` makes them
    from JAX or seeded trees) on ``device``, with fresh optimizers.
    ``device`` defaults to ``"cuda"`` and raises when no card is
    present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"create_train_state(device={str(device)!r}): no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    generator = VAEGANGenerator(cfg)
    discriminator = PatchDiscriminator(
        cond_vocab=cfg.vocab_size if cfg.conditional_disc else 0)
    generator.load_state_dict(g_state_dict)
    discriminator.load_state_dict(d_state_dict)
    return TrainState(cfg, generator.to(device), discriminator.to(device))
