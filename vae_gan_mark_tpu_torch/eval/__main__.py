"""Evaluation command line: round-trip metrics of a trained checkpoint of the
port on a dataset.

    python -m vae_gan_mark_tpu_torch.eval --variant v2 --workdir ./ckpts \\
        --json-dir .../all_annotations --ru-dir .../aug_ru \\
        --en-dir .../aug_en --mask-dir .../masks_from_ru_bbox

Runs the config's validation step over the val split (the trainer's
grouped split: ``cfg.split_seed``, ``cfg.val_split``), or over the
synthetic val set with ``--synthetic``, with the config's final KL weight,
and prints one JSON line of sample-weighted metrics: recon L1, PSNR, masked
L1, mark recovery and, for full-loss configs, the G, D, KL, GAN and
perceptual losses. Batch ``i`` draws its noise from ``(seed, i, step)``, as
the trainer's validation does. For vanilla and lr_sh the texts of an
on-disk dataset are embedded with the cached SBERT model;
``--allow-hash-embed`` accepts ``hash_embed`` when there is none. The card
is used unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    from vae_gan_mark_tpu_torch.cli import add_device_flag
    from vae_gan_mark_tpu_torch.config import VARIANTS
    p = argparse.ArgumentParser(prog="vae_gan_mark_tpu_torch.eval",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--workdir", required=True)
    p.add_argument("--checkpoint", default="best_model",
                   choices=("best_model", "last_checkpoint"))
    p.add_argument("--json-dir")
    p.add_argument("--ru-dir")
    p.add_argument("--en-dir")
    p.add_argument("--mask-dir")
    p.add_argument("--patch-cache", default=None, metavar="DIR",
                   help="persistent decoded-patch cache dir (shared with "
                        "training runs)")
    p.add_argument("--shuffle-text", action="store_true",
                   help="ablation: misalign the text conditioning by "
                        "rolling each batch's text rows by one; a model "
                        "that uses the text must do worse")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-samples", type=int, default=64)
    p.add_argument("--synthetic-text-vocab", type=int, default=0,
                   help="closed mark-string vocabulary size (must match "
                        "the training run's setting)")
    p.add_argument("--synthetic-text-tile", action="store_true",
                   help="watermark-style tiled synthetic task (must match "
                        "the training run's setting)")
    p.add_argument("--synthetic-structured", action="store_true",
                   help="smooth structured backgrounds (must match the "
                        "training run's setting)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--allow-hash-embed", action="store_true",
                   help="evaluate an sbert-variant checkpoint on disk data "
                        "with the hash_embed fallback when the SBERT model "
                        "is not cached locally (the metrics will not be "
                        "the trained model's; without it a missing SBERT "
                        "model is an error)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    add_device_flag(p)
    return p


def batches(cfg, args, text_embed_fn=None):
    bs = cfg.batch_size
    if args.synthetic:
        from vae_gan_mark_tpu_torch.data.synthetic import (
            SyntheticPatchDataset)
        ds = SyntheticPatchDataset(cfg, args.synthetic_samples,
                                   seed=args.seed + 1,
                                   text_vocab=args.synthetic_text_vocab,
                                   text_tile=args.synthetic_text_tile,
                                   structured=args.synthetic_structured)
        for i in range(max(args.synthetic_samples // bs, 1)):
            yield ds.batch(bs, i)
        return
    if not all((args.json_dir, args.ru_dir, args.en_dir, args.mask_dir)):
        raise SystemExit("--json-dir/--ru-dir/--en-dir/--mask-dir are "
                         "required without --synthetic")
    from vae_gan_mark_tpu_torch.data.index import build_index, grouped_split
    from vae_gan_mark_tpu_torch.data.pipeline import HostWarpLoader
    samples = build_index(args.json_dir, args.ru_dir, args.en_dir,
                          args.mask_dir)
    _, val_idx = grouped_split(samples, cfg.val_split, cfg.split_seed)
    yield from HostWarpLoader(cfg, samples, val_idx, batch_size=bs,
                              shuffle=False, drop_last=False, seed=args.seed,
                              text_embed_fn=text_embed_fn,
                              cache_dir=args.patch_cache)(0)


def main(argv=None):
    import numpy as np
    import torch

    from vae_gan_mark_tpu_torch.cli import parse_overrides
    from vae_gan_mark_tpu_torch.config import VariantConfig, get_config
    from vae_gan_mark_tpu_torch.models.vgg import VGG16Features
    from vae_gan_mark_tpu_torch.ops.precision import torch_dtype
    from vae_gan_mark_tpu_torch.train.checkpoint import load_state_file
    from vae_gan_mark_tpu_torch.train.loop import make_generator
    from vae_gan_mark_tpu_torch.train.state import (
        create_train_state, vgg_state_dict)
    from vae_gan_mark_tpu_torch.train.step import (
        batch_to_device, build_eval_step)

    args = build_parser().parse_args(argv)
    overrides = parse_overrides(VariantConfig, args.set)
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    cfg = get_config(args.variant, **overrides)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to evaluate on the CPU")
    text_embed_fn = None
    if cfg.text_encoder == "sbert" and not args.synthetic:
        # The trainer's embedder for on-disk texts; hash_embed only when
        # asked for.
        from vae_gan_mark_tpu_torch.data.text_embed import make_text_embedder
        text_embed_fn = make_text_embedder(
            require_sbert=not args.allow_hash_embed)

    saved = load_state_file(args.workdir, args.checkpoint)
    if saved is None:
        raise SystemExit(f"no checkpoint {args.checkpoint} in {args.workdir}")
    with open(f"{args.workdir}/{args.checkpoint}/host_meta.json") as f:
        epoch = json.load(f)["epoch"]
    state = create_train_state(cfg, saved["generator"],
                               saved["discriminator"], device)
    state.step = int(saved["step"])
    del saved
    vgg = VGG16Features(torch_dtype(cfg.compute_dtype))
    vgg.load_state_dict(vgg_state_dict())
    vgg.to(device)
    eval_step = build_eval_step(cfg)

    sums, n = None, 0
    for i, batch in enumerate(batches(cfg, args, text_embed_fn)):
        if batch is None:
            continue
        if args.shuffle_text:
            batch = dict(batch)
            batch["text"] = np.roll(np.asarray(batch["text"]), 1, axis=0)
        batch = batch_to_device(batch, device)
        # The config's final KL weight, as the trainer's full-loss
        # validation uses once the anneal is over.
        metrics, _ = eval_step(state, vgg, batch,
                               make_generator(device, args.seed, i,
                                              state.step),
                               float(np.float32(cfg.kl_weight)))
        b = batch["ru"].shape[0]
        weighted = {k: v * b for k, v in metrics.items()}
        sums = weighted if sums is None else {
            k: sums[k] + weighted[k] for k in sums}
        n += b
    if sums is None:
        raise SystemExit("no evaluable batches")
    values = torch.stack(list(sums.values())).tolist()
    avg = {k: round(v / n, 6) for k, v in zip(sums, values)}
    avg["samples"] = n
    avg["checkpoint_epoch"] = epoch
    print(json.dumps(avg))


if __name__ == "__main__":
    main()
