"""Evaluation (the JAX package's ``eval/__init__.py``): the patch metrics
and the full-image inference path.

* ``psnr``, ``masked_l1``, ``mark_recovery_rate``: patch metrics; images
  are NHWC, masks (B, H, W, 1) count where they exceed 0.5 (mark recovery:
  the share of masked pixels within a tolerance of the ground truth, an
  OCR-free proxy for "the text rendered right").
* ``generate_patch``: the generator in eval mode on a prepared batch.
* ``render_full_image``: crop the quad from a full image, generate, paste
  the patch back. As in the JAX package, the mask is cast to float32 before
  its uint8 test, so a uint8 mask is never rescaled to [0, 1].

``python -m vae_gan_mark_tpu_torch.eval`` evaluates a checkpoint.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vae_gan_mark_tpu_torch.data import as_batch_tensor


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean(torch.square(pred.float() - target.float()))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


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


@torch.no_grad()
def generate_patch(model, batch: dict,
                   generator: Optional[torch.Generator] = None):
    """Eval-mode forward of ``model`` (a ``VAEGANGenerator``) on a batch of
    tensors on its device; returns (fake, mu, logvar). The noise comes from
    ``batch["eps"]`` when given, else from ``generator``."""
    model.eval()
    return model(batch["ru"], batch["mask"], batch["text"],
                 eps=batch.get("eps"), generator=generator)


@torch.no_grad()
def render_full_image(model, image, mask_image, quad, text,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Full-image inference: crop ``quad`` -> generate -> paste back.

    image: (H, W, 3) float in [0, 1] or uint8; mask_image: (H, W, 1);
    quad: (4, 2) corners; text: (L,) tokens or an (sbert_dim,) embedding.
    Returns the full image, float32, with the region re-rendered.
    """
    from vae_gan_mark_tpu_torch.ops.warp import (
        perspective_crop_batch, perspective_unwarp)
    device = next(model.parameters()).device
    cfg = model.cfg
    h_src, w_src = image.shape[0], image.shape[1]
    img = torch.as_tensor(np.asarray(image), device=device)
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    # Cast before any uint8 test, as the JAX package does: a uint8 mask
    # keeps its 0-255 values.
    msk = torch.as_tensor(np.asarray(mask_image), dtype=torch.float32,
                          device=device)
    quad = torch.as_tensor(np.asarray(quad), dtype=torch.float32,
                           device=device)
    ru = perspective_crop_batch(img[None], quad[None], cfg.patch_h,
                                cfg.patch_w)
    mk = perspective_crop_batch(msk[None], quad[None], cfg.patch_h,
                                cfg.patch_w)
    text = as_batch_tensor("text", torch.as_tensor(np.asarray(text)))
    fake, _, _ = generate_patch(model, {"ru": ru, "mask": mk,
                                        "text": text.to(device)[None]},
                                generator)
    return perspective_unwarp(fake[0], quad, img, h_src, w_src)
