"""Patch metrics of the eval step (the JAX package's ``eval/__init__.py``):
the error restricted to the text mask, and the mark-recovery rate. Images
are NHWC; masks (B, H, W, 1) count where they exceed 0.5."""

from __future__ import annotations

import torch


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over the masked pixels and their channels."""
    diff = torch.abs(pred.float() - target.float())
    m = (mask > 0.5).float()
    return torch.sum(diff * m) / torch.clamp(torch.sum(m) * pred.shape[-1],
                                             min=1.0)


def mark_recovery_rate(pred: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor,
                       tolerance: float = 0.1) -> torch.Tensor:
    """Share of masked pixels whose channel-mean abs error < tolerance."""
    err = torch.mean(torch.abs(pred.float() - target.float()), dim=-1,
                     keepdim=True)
    ok = (err < tolerance).float()
    m = (mask > 0.5).float()
    return torch.sum(ok * m) / torch.clamp(torch.sum(m), min=1.0)
