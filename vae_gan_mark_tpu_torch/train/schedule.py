"""Host-side schedules: ReduceLROnPlateau and KL annealing (a copy of the
JAX package's ``train/schedule.py``).

Both act once per epoch on the host; the KL weight is an argument of every
train step and the learning rate lives in the optimizers' param groups, so
neither rebuilds anything.
"""

from __future__ import annotations

import dataclasses

from vae_gan_mark_tpu_torch.config import SchedulerConfig, VariantConfig


@dataclasses.dataclass
class PlateauState:
    """Mutable state of one ReduceLROnPlateau instance (mode='min',
    threshold_mode='rel', cooldown=0: torch's defaults)."""

    best: float = float("inf")
    num_bad_epochs: int = 0


def plateau_step(cfg: SchedulerConfig, state: PlateauState, metric: float,
                 lr: float) -> float:
    """Advance the scheduler with this epoch's metric; returns the new LR.

    An epoch is good if metric < best * (1 - threshold). After more than
    ``patience`` bad epochs in a row the LR is multiplied by ``factor``
    (floored at ``min_lr``) and the count of bad epochs restarts.
    """
    if metric < state.best * (1.0 - cfg.threshold):
        state.best = metric
        state.num_bad_epochs = 0
    else:
        state.num_bad_epochs += 1
    if state.num_bad_epochs > cfg.patience:
        state.num_bad_epochs = 0
        return max(lr * cfg.factor, cfg.min_lr)
    return lr


def kl_weight_for_epoch(cfg: VariantConfig, epoch: int) -> float:
    """Linear KL anneal: for epoch < kl_anneal_epochs, weight = start +
    (target - start) * epoch / (kl_anneal_epochs - 1); afterwards the target
    weight. With kl_anneal_epochs == 0 the weight is constant."""
    if cfg.kl_anneal_epochs <= 0 or epoch >= cfg.kl_anneal_epochs:
        return cfg.kl_weight
    denom = max(1, cfg.kl_anneal_epochs - 1)
    return cfg.start_kl_weight + (
        cfg.kl_weight - cfg.start_kl_weight) * (epoch / denom)
