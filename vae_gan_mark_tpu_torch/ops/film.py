"""Text-conditioning ops: SpatialFiLM and spatial broadcast (NCHW).

``SpatialFiLM`` bilinearly upsamples the text feature map (B, C_t, h_t, w_t)
to the decoder stage's (H, W), predicts per-pixel (gamma, beta) with
Conv3x3(bias=False) + BN + ReLU + Conv1x1, and returns gamma * x + beta.

Row-factored fast path (exact): a height-1 text map upsampled to H rows is
constant along y, so a 3x3 conv over it takes only three distinct values per
column -- the top row (zero-padded above: kernel rows 1+2), the interior rows
(rows 0+1+2) and the bottom row (rows 0+1). Each is a 3-tap conv along x.
The predictor then runs on a (B, C_t, 3, W) row-type tensor, and gamma and
beta are applied row by row without full-resolution maps. In eval mode BN
uses running statistics, so it needs no row weights.

Taller text maps (the oldv variant's height 4) take the naive path, which
computes the same function; the JAX package's strip-factored shortcut for
them is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vae_gan_mark_tpu_torch.ops.convblocks import Conv2d
from vae_gan_mark_tpu_torch.ops.norms import BatchNorm
from vae_gan_mark_tpu_torch.ops.resize import interpolate_bilinear


def spatial_broadcast(emb: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C) -> (B, C, h, w) by tiling."""
    return emb[:, :, None, None].expand(emb.shape[0], emb.shape[1], h, w)


class SpatialFiLM(nn.Module):
    """Per-pixel feature-wise linear modulation from spatial text features.

    ``param_predictor`` is ``[Conv3x3, BN, ReLU, Conv1x1]``, the reference's
    module layout, shared by both paths.
    """

    def __init__(self, num_features_main: int, text_ch: int,
                 fast: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features_main = num_features_main
        self.fast = fast
        self.dtype = dtype
        self.param_predictor = nn.Sequential(
            Conv2d(text_ch, text_ch, 3, padding=1, bias=False, dtype=dtype),
            BatchNorm(text_ch, dtype=dtype),
            nn.ReLU(),
            Conv2d(text_ch, 2 * num_features_main, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, text_map: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        c = self.num_features_main
        if self.fast and text_map.shape[2] == 1 and h >= 3:
            gb = self._fast_predict(text_map, w)            # (B, 2C, 3, W)
            gamma, beta = gb[:, :c], gb[:, c:]
            top = gamma[:, :, 0:1] * x[:, :, 0:1] + beta[:, :, 0:1]
            mid = gamma[:, :, 1:2] * x[:, :, 1:h - 1] + beta[:, :, 1:2]
            bot = gamma[:, :, 2:3] * x[:, :, h - 1:h] + beta[:, :, 2:3]
            return torch.cat([top, mid, bot], dim=2)
        t = interpolate_bilinear(text_map, h, w).to(self.dtype)
        gb = self.param_predictor(t)
        return gb[:, :c] * x + gb[:, c:]

    def _fast_predict(self, text_map: torch.Tensor, w: int) -> torch.Tensor:
        """Row-factored predictor for y-constant upsampled text maps."""
        conv3, bn, relu, conv1 = self.param_predictor
        t_x = interpolate_bilinear(text_map, 1, w).to(self.dtype)
        k = conv3.weight                                    # (Ct, Ct, 3, 3)
        row_kernels = (k[:, :, 1] + k[:, :, 2],             # top
                       k[:, :, 0] + k[:, :, 1] + k[:, :, 2],  # interior
                       k[:, :, 0] + k[:, :, 1])             # bottom
        rows = [F.conv2d(t_x, kr[:, :, None, :].to(self.dtype),
                         padding=(0, 1)) for kr in row_kernels]
        t_rows = relu(bn(torch.cat(rows, dim=2)))           # (B, Ct, 3, W)
        return conv1(t_rows)
