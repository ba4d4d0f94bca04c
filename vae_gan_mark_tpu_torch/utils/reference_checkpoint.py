"""A reference training checkpoint (``.pth``) into the port's modules (the
counterpart of the JAX package's ``tools/port_reference_checkpoint.py`` and
``utils/port_torch.py``).

The reference saves a dict with ``model_state_dict`` (the generator) and
``disc_state_dict`` (the discriminator) among its optimizer and scheduler
states. The port's generator and discriminator carry the reference's
state-dict keys (``models/vaegan.py``, ``models/discriminator.py``), so
those load as they are, strictly: a key missing on either side raises.
Only what the port does not keep is left out first:

* ``*.num_batches_tracked`` of every ``BatchNorm2d`` (the port's momentum
  is fixed, so the count is never read);
* ``*.weight_v`` of every spectral-norm conv (the port recomputes v from
  ``weight_u`` in each forward, as torch does);
* ``text_encoder.model.*``, the frozen MiniLM of vanilla and lr_sh: the
  port takes sentence embeddings as inputs (``data/text_embed.py``).

    python -m vae_gan_mark_tpu_torch.utils.reference_checkpoint \\
        last_checkpoint.pth OUT_DIR [--variant v2] [--set key=value]

writes ``OUT_DIR/best_model/state.pt`` with the generator and, when the
checkpoint has one, the discriminator, which the serve and export CLIs
read (``--workdir OUT_DIR``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

DROPPED_SUFFIXES = (".num_batches_tracked", ".weight_v")
DROPPED_PREFIXES = ("text_encoder.model.",)


def port_keys(state_dict: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """``state_dict`` without the entries the port does not keep."""
    return {k: v for k, v in state_dict.items()
            if not k.endswith(DROPPED_SUFFIXES)
            and not k.startswith(DROPPED_PREFIXES)}


def load_reference_checkpoint(checkpoint, cfg
                              ) -> Tuple[torch.nn.Module,
                                         Optional[torch.nn.Module]]:
    """(generator, discriminator or None) of ``cfg``, on the CPU, loaded
    strictly from ``checkpoint``: a path or the loaded dict (or a bare
    generator state dict)."""
    from vae_gan_mark_tpu_torch.models.discriminator import PatchDiscriminator
    from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator

    if not isinstance(checkpoint, Mapping):
        checkpoint = torch.load(checkpoint, map_location="cpu",
                                weights_only=False)
    g_sd = checkpoint.get("model_state_dict", checkpoint)
    generator = VAEGANGenerator(cfg)
    generator.load_state_dict(port_keys(g_sd), strict=True)
    discriminator = None
    if "disc_state_dict" in checkpoint:
        discriminator = PatchDiscriminator()
        discriminator.load_state_dict(
            port_keys(checkpoint["disc_state_dict"]), strict=True)
    return generator, discriminator


def main(argv=None):
    from vae_gan_mark_tpu_torch.cli import parse_overrides
    from vae_gan_mark_tpu_torch.config import (
        VARIANTS, VariantConfig, get_config)
    from vae_gan_mark_tpu_torch.train.checkpoint import STATE_FILE

    p = argparse.ArgumentParser(
        prog="python -m vae_gan_mark_tpu_torch.utils.reference_checkpoint",
        description="load a reference .pth checkpoint into the port")
    p.add_argument("checkpoint")
    p.add_argument("out", help="directory: OUT/best_model/state.pt")
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)
    cfg = get_config(args.variant, **parse_overrides(VariantConfig, args.set))
    generator, discriminator = load_reference_checkpoint(args.checkpoint, cfg)
    state = {"generator": generator.state_dict()}
    if discriminator is not None:
        state["discriminator"] = discriminator.state_dict()
    path = os.path.join(args.out, "best_model")
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, STATE_FILE))
    print(f"loaded {len(state['generator'])} generator tensors"
          f"{'' if discriminator is None else ' and the discriminator'} "
          f"-> {path}")


if __name__ == "__main__":
    main()
