"""The model's operations, counted once from the plain reference with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device at the
cell's shapes, and split by the precision that the configuration states
for them: the discriminator and the GRU (input projection and recurrence)
in float32, every other convolution and product (the generator's, the VGG
head's) in bf16. The count is of the work, never of what the program
launches.

* A train step: G's forward and backward; D's update (its forward on real
  and fake, its backward) and its forward and backward to the input in G's
  update; VGG's forward on both images and its input gradient.
* Serving: G's forward in eval mode, per requested patch.

Where the configuration states ``fast_film``, SpatialFiLM's predictor is
counted as that option computes it, exactly and with far fewer operations
(the reference computes it at full resolution): for a height-1 text map,
three 3-tap convolutions along x of the map resized to the stage's width
give the three row types (top, interior, bottom) of the 3x3 convolution of
the upsampled map, and the 1x1 convolution runs on those three rows; for a
text map of 1 < h_t < H rows, three 3-tap convolutions of the h_t rows are
mixed to H rows by one (H, 3 h_t) product, and the 1x1 convolution runs at
full size.
"""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from reference.model import SpatialFiLM, bilinear
from reference.train import Adam, Models, train_step

F32_MODULES = ("Discriminator", "char_text_encoder_module.rnn")


def _split(counts: Dict[str, Dict]) -> Dict[str, float]:
    def total(name):
        return float(sum(counts.get(name, {}).values()))
    f32 = 0.0
    for key in counts:
        if key == "Discriminator" or key.endswith(
                ".char_text_encoder_module.rnn"):
            f32 += total(key)
    return {"bf16": total("Global") - f32, "f32": f32}


def _factored_film(self, x, text_map, q):
    """SpatialFiLM as ``fast_film`` computes it, for the count alone."""
    p = self.param_predictor._modules
    h, w = x.shape[2], x.shape[3]
    h_t = text_map.shape[2]
    k = p["0"].weight                                   # (Ct, Ct, 3, 3)
    if h_t == 1 and h >= 3:
        t = bilinear(text_map, 1, w)
        rows = torch.cat([F.conv2d(t, k[:, :, i:i + 1], padding=(0, 1))
                          for i in range(3)], dim=2)    # (B, Ct, 3, W)
        gb = p["3"](F.relu(p["1"](rows)), q)
        c = self.c
        g, b = gb[:, :c], gb[:, c:]
        return torch.cat([g[:, :, 0:1] * x[:, :, :1] + b[:, :, 0:1],
                          g[:, :, 1:2] * x[:, :, 1:h - 1] + b[:, :, 1:2],
                          g[:, :, 2:3] * x[:, :, h - 1:] + b[:, :, 2:3]],
                         dim=2)
    if 1 < h_t < h:
        t = bilinear(text_map, h_t, w)
        strips = torch.cat([F.conv2d(t, k[:, :, i:i + 1], padding=(0, 1))
                            for i in range(3)], dim=2)  # (B, Ct, 3 h_t, W)
        mix = torch.zeros(h, 3 * h_t, device=x.device)
        gb = p["3"](F.relu(p["1"](torch.matmul(mix, strips))), q)
        return gb[:, :self.c] * x + gb[:, self.c:]
    return SpatialFiLM.forward(self, x, text_map, q)


def _counted(cfg: dict):
    if not cfg.get("fast_film"):
        return contextlib.nullcontext()
    return mock.patch.object(SpatialFiLM, "forward", _factored_film)


def _batch(cfg: dict, rows: int) -> dict:
    h, w = cfg["patch_h"], cfg["patch_w"]
    return {"ru": torch.rand(rows, h, w, 3), "en": torch.rand(rows, h, w, 3),
            "mask": torch.rand(rows, h, w, 1),
            "text": torch.zeros(rows, cfg["max_text_len"], dtype=torch.long)}


def train_step_flops(cfg: dict, rows: int) -> Dict[str, float]:
    with torch.device("meta"):
        models = Models(cfg, None, None, None, "meta")
        betas = (cfg["adam_b1"], cfg["adam_b2"])
        opt_g = Adam(models.g_params.values(), cfg["lr_g"], betas)
        opt_d = Adam(models.d_params.values(), cfg["lr_d"], betas)
        batch = _batch(cfg, rows)
        with _counted(cfg), FlopCounterMode(display=False) as counter:
            train_step(models, opt_g, opt_d, batch, None, cfg["kl_weight"])
    return _split(counter.get_flop_counts())


def generate_flops_per_patch(cfg: dict, rows: int) -> Dict[str, float]:
    with torch.device("meta"):
        models = Models(cfg, None, None, None, "meta")
        models.g.eval()
        batch = _batch(cfg, rows)
        eps = torch.zeros(rows, cfg["z_ch"], 1, 1)
        with torch.no_grad(), _counted(cfg), \
                FlopCounterMode(display=False) as counter:
            models.g(batch["ru"], batch["mask"], batch["text"], eps=eps)
    return {k: v / rows for k, v in
            _split(counter.get_flop_counts()).items()}
