"""Text-conditioning ops: SpatialFiLM, gated skips and spatial broadcast
(NCHW).

``SpatialFiLM`` bilinearly upsamples the text feature map (B, C_t, h_t, w_t)
to the decoder stage's (H, W), predicts per-pixel (gamma, beta) with
Conv3x3(bias=False) + BN + ReLU + Conv1x1, and returns gamma * x + beta. The
JAX package's two exact shortcuts for that predictor are kept:

* Row-factored path, for a height-1 text map (v2): upsampled to H rows it is
  constant along y, so a 3x3 conv over it takes only three distinct values
  per column -- the top row (zero-padded above: kernel rows 1+2), the
  interior rows (rows 0+1+2) and the bottom row (rows 0+1). Each is a 3-tap
  conv along x. The predictor then runs on a (B, C_t, 3, W) row-type
  tensor, and gamma and beta are applied row by row without
  full-resolution maps. In train mode BN weights the three row types by
  their multiplicities (1, H-2, 1), with n = B*W*H, so that its statistics
  and running update equal the full map's (the JAX package's
  ``_batch_norm(weights=...)``); in eval mode it uses the running
  statistics.
* Strip-factored path, for 1 < h_t < H (oldv's height 4): the y-upsampled
  map is a fixed linear combination of the h_t source rows, so the 3x3 conv
  of the upsampled map is, for each kernel row, a 3-tap conv along x of the
  h_t rows, mixed to H rows by the y-interpolation matrix shifted by that
  kernel row's offset (zero outside the map: the conv's padding). The
  matrix comes from resizing an identity with ``interpolate_bilinear``
  itself, so its edge conventions are the resize's. The predictor's 3x3
  conv costs h_t rows instead of H; BN takes plain statistics of the
  (B, C_t, H, W) result, and the 1x1 conv runs at full resolution.

Any other map takes the naive path, which computes the same function.

``GatedSkip`` is oldv's per-channel gate on a skip connection,
``skip * sigmoid(alpha)``, alpha initialised to 0.3 and held as the
reference's (1, C, 1, 1) ``alpha``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vae_gan_mark_tpu_torch.ops.constants import device_constant
from vae_gan_mark_tpu_torch.ops.convblocks import Conv2d
from vae_gan_mark_tpu_torch.ops.norms import BatchNorm
from vae_gan_mark_tpu_torch.ops.resize import interpolate_bilinear


def spatial_broadcast(emb: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C) -> (B, C, h, w) by tiling."""
    return emb[:, :, None, None].expand(emb.shape[0], emb.shape[1], h, w)


class GatedSkip(nn.Module):
    """skip * sigmoid(alpha), alpha per channel, initialised to 0.3; the
    gate is computed in float32 and cast to the skip's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1, channels, 1, 1), 0.3))

    def forward(self, skip: torch.Tensor) -> torch.Tensor:
        return skip * torch.sigmoid(self.alpha).to(skip.dtype)


def y_interp_matrix(h_t: int, h: int) -> torch.Tensor:
    """(h, h_t) float32: row y holds the weights of the h_t source rows in
    the bilinear resize to h rows, from resizing an identity."""
    eye = torch.eye(h_t, dtype=torch.float32)
    return interpolate_bilinear(eye[None, None], h, h_t)[0, 0]


def strip_mix_matrix(h_t: int, h: int) -> torch.Tensor:
    """(h, 3 h_t) float32: for kernel rows 0, 1, 2 (offsets -1, 0, +1), the
    rows y - 1, y, y + 1 of ``y_interp_matrix`` that output row y reads,
    zero where they fall outside the map."""
    w_interp = y_interp_matrix(h_t, h)
    zero = torch.zeros(1, h_t)
    up = torch.cat([zero, w_interp[:-1]])
    down = torch.cat([w_interp[1:], zero])
    return torch.cat([up, w_interp, down], dim=1)


class SpatialFiLM(nn.Module):
    """Per-pixel feature-wise linear modulation from spatial text features.

    ``param_predictor`` is ``[Conv3x3, BN, ReLU, Conv1x1]``, the reference's
    module layout, shared by every path.
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
        h_t = text_map.shape[2]
        c = self.num_features_main
        if self.fast and h_t == 1 and h >= 3:
            gb = self._fast_predict(text_map, h, w)         # (B, 2C, 3, W)
            gamma, beta = gb[:, :c], gb[:, c:]
            top = gamma[:, :, 0:1] * x[:, :, 0:1] + beta[:, :, 0:1]
            mid = gamma[:, :, 1:2] * x[:, :, 1:h - 1] + beta[:, :, 1:2]
            bot = gamma[:, :, 2:3] * x[:, :, h - 1:h] + beta[:, :, 2:3]
            return torch.cat([top, mid, bot], dim=2)
        if self.fast and 1 < h_t < h:
            _, bn, relu, conv1 = self.param_predictor
            gb = conv1(relu(bn(self._strip_conv(text_map, h, w))))
        else:
            t = interpolate_bilinear(text_map, h, w).to(self.dtype)
            gb = self.param_predictor(t)
        return gb[:, :c] * x + gb[:, c:]

    def _fast_predict(self, text_map: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
        """Row-factored predictor for y-constant upsampled text maps."""
        conv3, bn, relu, conv1 = self.param_predictor
        t_x = interpolate_bilinear(text_map, 1, w).to(self.dtype)
        k = conv3.weight                                    # (Ct, Ct, 3, 3)
        row_kernels = (k[:, :, 1] + k[:, :, 2],             # top
                       k[:, :, 0] + k[:, :, 1] + k[:, :, 2],  # interior
                       k[:, :, 0] + k[:, :, 1])             # bottom
        rows = [F.conv2d(t_x, kr[:, :, None, :].to(self.dtype),
                         padding=(0, 1)) for kr in row_kernels]
        t_rows = bn(torch.cat(rows, dim=2),                 # (B, Ct, 3, W)
                    row_weights=(1.0, float(h - 2), 1.0))
        t_rows = relu(t_rows)
        return conv1(t_rows)

    def _strip_conv(self, text_map: torch.Tensor, h: int,
                    w: int) -> torch.Tensor:
        """conv3x3(bilinear_upsample(text_map) to (h, w)) from the text
        map's h_t rows: (B, Ct, h, w) in the compute dtype."""
        k = self.param_predictor[0].weight                  # (Ct, Ct, 3, 3)
        h_t = text_map.shape[2]
        t_x = interpolate_bilinear(text_map, h_t, w).to(self.dtype)
        # One 3-tap conv along x per kernel row, the h_t rows of each
        # stacked: (B, Ct, 3 h_t, w).
        strips = torch.cat([
            F.conv2d(t_x, k[:, :, ki:ki + 1].to(self.dtype), padding=(0, 1))
            for ki in range(3)], dim=2).float()
        mix = device_constant(("strip_mix", h_t, h), text_map.device,
                              lambda: strip_mix_matrix(h_t, h))
        return torch.matmul(mix, strips).to(self.dtype)     # (B, Ct, h, w)
