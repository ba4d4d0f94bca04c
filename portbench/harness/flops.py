"""The model's operations, counted once from the plain reference with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device at the
cell's shapes, and split by the precision that the configuration states
for them: the discriminator and the generator's modules that its
reference module names in ``F32_MODULES`` (the char path's GRU: input
projection and recurrence) in float32, every other convolution and product
(the generator's, the VGG head's) in bf16. The count is of the work, never
of what the program launches.

* A train step: G's forward and backward; D's update (its forward on real
  and fake, its backward) and its forward and backward to the input in G's
  update; VGG's forward on both images and its input gradient.
* Serving: G's forward in eval mode, per requested patch.

The generator, its stand-in text (``example_text``) and the context of
the count (``counted``: for the char U-Nets, SpatialFiLM as ``fast_film``
computes it, exactly and with far fewer operations than the reference's
full-resolution predictor) come from the cell's reference module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.train import Adam, Models, train_step

F32_SHARED = ("Discriminator",)


def _split(counts: Dict[str, Dict], f32_modules: Sequence[str]
           ) -> Dict[str, float]:
    """bf16 and float32 operations: a module counts at float32 where its
    name is one of ``f32_modules`` or ends in ``.`` and one of them (they
    name no module inside another)."""
    def total(name):
        return float(sum(counts.get(name, {}).values()))
    f32 = 0.0
    for key in counts:
        if any(key == m or key.endswith("." + m) for m in f32_modules):
            f32 += total(key)
    return {"bf16": total("Global") - f32, "f32": f32}


def _batch(arch, cfg: dict, rows: int) -> dict:
    h, w = cfg["patch_h"], cfg["patch_w"]
    return {"ru": torch.rand(rows, h, w, 3), "en": torch.rand(rows, h, w, 3),
            "mask": torch.rand(rows, h, w, 1),
            "text": arch.example_text(cfg, rows)}


def train_step_flops(arch, cfg: dict, rows: int) -> Dict[str, float]:
    """A train step's operations at ``rows`` a batch; ``arch`` is the
    configuration's reference module."""
    with torch.device("meta"):
        models = Models(arch, cfg, None, None, None, "meta")
        betas = (cfg["adam_b1"], cfg["adam_b2"])
        opt_g = Adam(models.g_params.values(), cfg["lr_g"], betas)
        opt_d = Adam(models.d_params.values(), cfg["lr_d"], betas)
        batch = _batch(arch, cfg, rows)
        with arch.counted(cfg), FlopCounterMode(display=False) as counter:
            train_step(models, opt_g, opt_d, batch, None, cfg["kl_weight"])
    return _split(counter.get_flop_counts(), F32_SHARED + arch.F32_MODULES)


def generate_flops_per_patch(arch, cfg: dict, rows: int
                             ) -> Dict[str, float]:
    """A patch's share of the generator's eval forward at ``rows`` a
    batch."""
    with torch.device("meta"):
        models = Models(arch, cfg, None, None, None, "meta")
        models.g.eval()
        batch = _batch(arch, cfg, rows)
        eps = torch.zeros(rows, cfg["z_ch"], 1, 1)
        with torch.no_grad(), arch.counted(cfg), \
                FlopCounterMode(display=False) as counter:
            models.g(batch["ru"], batch["mask"], batch["text"], eps=eps)
    return {k: v / rows for k, v in _split(
        counter.get_flop_counts(), F32_SHARED + arch.F32_MODULES).items()}
