"""Training state: the generator and the discriminator (with their buffers:
G's BatchNorm running statistics, D's spectral ``u``), two Adam optimizers
and the step count. The JAX package's counterpart is ``train/state.py``.

The reference keeps two Adam optimizers with betas (0.5, 0.999) and eps
1e-8. ``torch.optim.Adam`` computes optax's update,
``lr * m_hat / (sqrt(v_hat) + eps)``. G's gradient is clipped to the global
norm ``cfg.grad_clip_norm`` before its Adam step (``clip_by_global_norm_``);
D's is not clipped. Learning rates can change between steps
(``get_lr`` / ``set_lr``), as the plateau schedule does between epochs.

On the card both Adams are ``capturable``: their step counts and learning
rates are float32 tensors on the card, so a CUDA graph of the train step
(``train/graphs.py``) replays their update and ``set_lr`` writes the rate
the graph reads. That holds for every ``multi_step``: a capturable Adam
computes its bias corrections on the card in float32, which moves a step's
parameters by a few ulps against the CPU-side arithmetic of a plain one, so
one kind of Adam for every K keeps K = 1 and K > 1 equal bit for bit. On
the CPU the Adams are plain, with the step count on the CPU and a float
rate. ``load_optimizer_state`` loads a checkpoint's Adam into either kind.

``init_state_dicts(cfg, seed)`` draws a fresh G and D from the JAX
initializers' distributions; ``vgg_state_dict()`` gives the frozen VGG head
(ported weights from ``tools/vgg16_features.npz`` when present, else a
fixed-seed random head).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.discriminator import PatchDiscriminator
from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator
from vae_gan_mark_tpu_torch.parallel import mesh
from vae_gan_mark_tpu_torch.utils.port_jax import (  # noqa: F401
    disc_cond_args, init_state_dicts, init_vgg_state_dict,
    vgg_state_dict_from_jax)

# Ported torchvision VGG16 weights, when present (``tools/port_vgg16.py``
# writes them: ``conv{i}_kernel`` HWIO and ``conv{i}_bias``).
VGG_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tools", "vgg16_features.npz")
# The seed of the random VGG used without that file. The JAX package draws
# its random VGG from PRNGKey(16), which torch cannot reproduce: the port's
# has the same distributions (lecun_normal kernels, zero biases), other
# values.
VGG_SEED = 16


def vgg_state_dict(path: str = VGG_WEIGHTS_PATH) -> Dict[str, torch.Tensor]:
    """The perceptual loss's frozen VGG16 head: the weights at ``path``
    when the file exists, else a fixed-seed random init."""
    if os.path.exists(path):
        data = np.load(path)
        return vgg_state_dict_from_jax({
            f"conv{i}": {"kernel": data[f"conv{i}_kernel"],
                         "bias": data[f"conv{i}_bias"]} for i in range(7)})
    return init_vgg_state_dict(VGG_SEED)


def make_adam(params: Iterable[torch.nn.Parameter], lr: float,
              cfg: VariantConfig, device: torch.device) -> torch.optim.Adam:
    """The reference's Adam, ``capturable`` with a float32 rate tensor on
    the card (see the module doc)."""
    if device.type == "cuda":
        return torch.optim.Adam(
            params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
            betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(cfg.adam_b1, cfg.adam_b2),
                            eps=1e-8)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient times
    ``max_norm / ||g||`` when the global norm ``||g|| >= max_norm``, else
    unchanged. (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (||g|| + 1e-6)``, another function.) Returns ``||g||``.
    A partitioned parameter (``parallel/mesh.py:partition_params``) holds
    a block of its gradient: its norm is summed over the model group, so
    every rank clips by the norm of the whole gradient."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    sharded = [i for i, p in enumerate(params)
               if mesh.sharded_dim(p) is not None]
    if sharded:
        index = torch.tensor(sharded, device=norms.device)
        squares = mesh.model_sum_(norms[index].square())
        norms = norms.index_copy(0, index, squares.sqrt())
    norm = torch.linalg.vector_norm(norms)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def get_lr(opt: torch.optim.Optimizer) -> float:
    """The first group's learning rate (one host sync for a rate tensor)."""
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate; a rate tensor is written in place, so a
    captured graph that reads it sees the new rate."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(opt: torch.optim.Optimizer, saved: Mapping) -> None:
    """``opt.load_state_dict(saved)`` that keeps ``opt``'s own kind: its
    ``capturable`` flag and rate object (a checkpoint of the other kind, or
    from the other device, loads all the same), the step counts on the card
    for a capturable Adam and on the CPU for a plain one."""
    kept = [(g["capturable"], g["lr"]) for g in opt.param_groups]
    opt.load_state_dict(saved)
    for group, (capturable, lr) in zip(opt.param_groups, kept):
        saved_lr = float(group["lr"])
        group["capturable"] = capturable
        group["lr"] = (lr.fill_(saved_lr) if isinstance(lr, torch.Tensor)
                       else saved_lr)
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                state["step"] = (state["step"].to(p.device, torch.float32)
                                 if capturable else state["step"].cpu())


class TrainState:
    """Everything a train step reads and writes. The modules hold their
    buffers; the step updates modules and optimizers in place."""

    def __init__(self, cfg: VariantConfig, generator: VAEGANGenerator,
                 discriminator: PatchDiscriminator):
        self.generator = generator
        self.discriminator = discriminator
        device = next(generator.parameters()).device
        self.opt_g = make_adam(generator.parameters(), cfg.lr_g, cfg, device)
        self.opt_d = make_adam(discriminator.parameters(), cfg.lr_d, cfg,
                               device)
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
    discriminator = PatchDiscriminator(**disc_cond_args(cfg))
    generator.load_state_dict(g_state_dict)
    discriminator.load_state_dict(d_state_dict)
    return TrainState(cfg, generator.to(device), discriminator.to(device))
