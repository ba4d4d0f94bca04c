"""Bilinear resize, ``align_corners=False`` and no antialias (the JAX
package's ``jax.image.resize(method='linear', antialias=False)``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Resize an NCHW tensor spatially to (out_h, out_w), in float32."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.to(x.dtype)
