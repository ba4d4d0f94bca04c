"""Serving command line: render new text into an image region with a trained
checkpoint of the port.

    python -m vae_gan_mark_tpu_torch.serve --variant v2 \\
        --workdir ./checkpoints --image creative.png --mask mask.png \\
        --quad 120,40,580,48,574,112,116,104 --text "NEW TEXT" \\
        --out rendered.png

The full-image path crops the quad, generates the patch and pastes it back
(``InferenceEngine.render``). ``--checkpoint`` picks ``best_model``
(default) or ``last_checkpoint``; ``--set`` overrides config fields and must
match the training run's. The card is used unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from vae_gan_mark_tpu_torch.cli import add_device_flag
    from vae_gan_mark_tpu_torch.config import VARIANTS
    p = argparse.ArgumentParser(prog="vae_gan_mark_tpu_torch.serve",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--workdir", required=True,
                   help="training workdir holding the checkpoints")
    p.add_argument("--checkpoint", default="best_model",
                   choices=("best_model", "last_checkpoint"))
    p.add_argument("--image", required=True, help="input image (any size)")
    p.add_argument("--mask", required=True,
                   help="text-region mask image (L or RGB)")
    p.add_argument("--quad", required=True,
                   help="8 comma-separated numbers: x0,y0,...,x3,y3 "
                        "(the bbox_ru quad, clockwise from top-left)")
    p.add_argument("--text", required=True, help="target text to render")
    p.add_argument("--out", required=True, help="output PNG path")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    add_device_flag(p)
    return p


def main(argv=None):
    from PIL import Image

    from vae_gan_mark_tpu_torch.cli import check_variant, parse_overrides
    from vae_gan_mark_tpu_torch.config import VariantConfig, get_config
    from vae_gan_mark_tpu_torch.serve.engine import InferenceEngine

    args = build_parser().parse_args(argv)
    cfg = get_config(args.variant,
                     **parse_overrides(VariantConfig, args.set))
    check_variant(cfg)
    quad = np.asarray([float(x) for x in args.quad.split(",")],
                      np.float32).reshape(4, 2)
    image = np.asarray(Image.open(args.image).convert("RGB"))
    mask = np.asarray(Image.open(args.mask).convert("L"))
    engine = InferenceEngine.from_checkpoint(
        cfg, args.workdir, name=args.checkpoint,
        batch_size=args.batch_size, seed=args.seed, device=args.device)
    out = engine.render(image, mask, quad, args.text)
    out8 = np.clip(np.asarray(out) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(out8).save(args.out)
    print(f"rendered '{args.text}' -> {args.out}")


if __name__ == "__main__":
    main()
