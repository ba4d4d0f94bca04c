"""Training command line of the port (the JAX package's ``cli.py``):

    python -m vae_gan_mark_tpu_torch.train --variant v2 \\
        --json-dir ... --ru-dir ... --en-dir ... --mask-dir ... \\
        [--epochs N] [--batch-size N] [--workdir DIR] [--synthetic]

Every config field can be overridden (``--set key=value``); credentials come
only from the environment (``WANDB_API_KEY``). The run uses the card unless
``--device cpu`` is given, and fails without one. Running the same command
again resumes from the workdir's ``last_checkpoint``.

Every variant trains: vanilla and lr_sh (the plain generator, sbert text
embedded on the host: the cached SBERT model, else ``hash_embed`` with a
warning), unet, v2 and oldv; ``--set conditional_disc=1`` adds the
projection-conditional discriminator head. ``--multi-step K`` runs K train
steps (and K val batches) per call, on the card as CUDA-graph replays of
one step. ``--loader device`` decodes and crops on the host and warps on
the card (``data/device_pipeline.py``); the default ``--loader host`` warps
on the host's worker threads and takes ``--patch-cache``.

Several processes (one per card, or on the CPU with ``--device cpu``)
train as one run on the global batch ``--batch-size``: start the same
command once per process with ``--coordinator HOST:PORT --num-processes N
--process-id I``, or under ``torchrun``, whose environment stands in for
the flags. Each process loads its rows of every batch; process 0 writes
the record and the checkpoints. ``--no-mesh`` runs one process without a
process group (no collectives).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from vae_gan_mark_tpu_torch.config import VARIANTS, get_config

def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default; fails without one) or "
                        "on the CPU")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vae_gan_mark_tpu_torch.train",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--json-dir", help="annotation dir (*.json)")
    p.add_argument("--ru-dir", help="RU images dir")
    p.add_argument("--en-dir", help="EN images dir")
    p.add_argument("--mask-dir", help="mask dir ({base}_ru.png)")
    p.add_argument("--workdir", default="./checkpoints_vaegan",
                   help="checkpoints + logs dir")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (smoke/bench)")
    p.add_argument("--synthetic-samples", type=int, default=256)
    p.add_argument("--device-data", choices=("auto", "on", "off"),
                   default="auto",
                   help="keep the synthetic dataset on the device and "
                        "gather batches there (auto: on when it takes "
                        "less than 4 GiB)")
    p.add_argument("--synthetic-text-vocab", type=int, default=0,
                   help="draw synthetic mark strings from a closed N-string "
                        "vocabulary shared across seeds (0 = per-sample "
                        "random strings)")
    p.add_argument("--synthetic-text-tile", action="store_true",
                   help="watermark-style synthetic task: the mark string "
                        "tiled at fixed positions across the patch, "
                        "visible inside the mask")
    p.add_argument("--synthetic-structured", action="store_true",
                   help="smooth upsampled-noise backgrounds instead of "
                        "per-pixel noise")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--loader", choices=("host", "device"), default="host",
                   help="on-disk data: 'host' decodes and warps on host "
                        "worker threads (cv2 or the native warp; with "
                        "--patch-cache later epochs stream from a memmap); "
                        "'device' decodes and bucket-crops on the host and "
                        "warps on the device (data/device_pipeline.py), "
                        "EXPERIMENTAL")
    p.add_argument("--patch-cache", default=None, metavar="DIR",
                   help="persistent decoded-patch cache dir (host loader "
                        "only): decode and "
                        "warp each sample once, stream later epochs from a "
                        "memmap; prewarm with python -m "
                        "vae_gan_mark_tpu_torch.data.patch_cache")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of epoch 2 here")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): find the "
                        "op that made a NaN (slow)")
    # Any config field is overridable: --set epochs=10 --set lr_g=2e-4
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="override a VariantConfig field")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--multi-step", type=int, default=1,
                   help="train steps (and val batches) per call; on the card "
                        "K > 1 replays a CUDA graph of one step K times "
                        "(the JAX package's scanned multi-step dispatch)")
    p.add_argument("--no-mesh", action="store_true",
                   help="one process without a process group: no "
                        "collectives (refused with several processes)")
    # Multi-process: --coordinator (and --num-processes, --process-id) on
    # every process, or torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK.
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for torch.distributed")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    add_device_flag(p)
    return p


def parse_overrides(cfg_cls, pairs):
    fields = {f.name: f.type for f in dataclasses.fields(cfg_cls)}
    out = {}
    for pair in pairs:
        key, _, val = pair.partition("=")
        if "." in key:
            # Nested dataclass field, e.g. scheduler.patience=5.
            head, _, sub = key.partition(".")
            if head not in fields:
                raise SystemExit(f"unknown config field: {head}")
            parent = getattr(get_config("v2"), head)
            subfields = {f.name for f in dataclasses.fields(parent)}
            if sub not in subfields:
                raise SystemExit(f"unknown config field: {key}")
            current = getattr(parent, sub)
        else:
            if key not in fields:
                raise SystemExit(f"unknown config field: {key}")
            current = getattr(get_config("v2"), key)
        if isinstance(current, bool):
            out[key] = val.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            out[key] = int(val)
        elif isinstance(current, float):
            out[key] = float(val)
        elif isinstance(current, tuple):
            out[key] = tuple(int(x) for x in val.split(","))
        else:
            out[key] = val
    return out


def synthetic_sources(cfg, args, device):
    """Train and val data sources over the synthetic dataset: train batch i
    of epoch e is ``batch(bs, i + e * steps)``, val batch i ``batch(bs,
    i)``, on the device (gathered there) or from the host; with several
    processes each process takes its rows of every batch, from the
    host."""
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.parallel import mesh
    options = dict(text_vocab=args.synthetic_text_vocab,
                   text_tile=args.synthetic_text_tile,
                   structured=args.synthetic_structured)
    train_ds = SyntheticPatchDataset(cfg, args.synthetic_samples,
                                     seed=args.seed, **options)
    val_ds = SyntheticPatchDataset(cfg, max(args.synthetic_samples // 8,
                                            cfg.batch_size),
                                   seed=args.seed + 1, **options)
    bs = cfg.batch_size
    steps = args.synthetic_samples // bs
    val_steps = max(steps // 8, 1)
    est_bytes = train_ds.ru.nbytes + train_ds.en.nbytes + train_ds.mask.nbytes
    several = mesh.data_count() > 1
    if args.device_data == "on" and several:
        raise SystemExit("--device-data on holds the whole set in one "
                         "process; a multi-process run loads each "
                         "process's rows from the host")
    if args.device_data == "on" or (args.device_data == "auto" and not
                                    several and est_bytes < 4 << 30):
        from vae_gan_mark_tpu_torch.data.device_synthetic import (
            DeviceResidentSynthetic)
        train_data = DeviceResidentSynthetic(train_ds, bs, steps,
                                             device=device)
        val_data = DeviceResidentSynthetic(val_ds, bs, val_steps,
                                           advance_per_epoch=False,
                                           device=device)
        print(f"device-resident synthetic data: "
              f"{train_data.nbytes() / 1e6:.0f} MB train + "
              f"{val_data.nbytes() / 1e6:.0f} MB val on {device}")
        return train_data, val_data

    def train_data(epoch):
        for i in range(steps):
            yield mesh.shard_batch(train_ds.batch(bs, i + epoch * steps))

    def val_data(epoch):
        for i in range(val_steps):
            yield mesh.shard_batch(val_ds.batch(bs, i))

    return train_data, val_data


def disk_sources(cfg, args, device):
    """Train and val loaders over the on-disk dataset, split as the
    reference does (grouped by RU image, ``cfg.val_split``,
    ``cfg.split_seed``): ``HostWarpLoader``, or with ``--loader device``
    ``DeviceWarpLoader`` warping on ``device``. With several data-parallel
    processes each loads a contiguous
    shard of equal length of each split, in batches of its rows, and the
    trailing partial val batch is dropped, so that every process runs the
    same number of batches of the same shape (a process with one more
    would wait for the others' collectives forever)."""
    from vae_gan_mark_tpu_torch.data.index import build_index, grouped_split
    from vae_gan_mark_tpu_torch.parallel import mesh
    if not all((args.json_dir, args.ru_dir, args.en_dir, args.mask_dir)):
        raise SystemExit("--json-dir/--ru-dir/--en-dir/--mask-dir are "
                         "required without --synthetic")
    if args.loader == "device":
        if args.patch_cache:
            raise SystemExit("--patch-cache requires --loader host (the "
                             "device loader warps on-chip)")
        print("[warn] --loader device is experimental: the host decodes "
              "and crops every sample each epoch and the device warps it; "
              "--loader host --patch-cache DIR streams later epochs from a "
              "memmap instead (chip_smoke.py phase 15 times both loaders)",
              flush=True)
        from vae_gan_mark_tpu_torch.data.device_pipeline import (
            DeviceWarpLoader)
        loader, extra = DeviceWarpLoader, dict(device=device)
    else:
        from vae_gan_mark_tpu_torch.data.pipeline import HostWarpLoader
        loader, extra = HostWarpLoader, dict(cache_dir=args.patch_cache)
    samples = build_index(args.json_dir, args.ru_dir, args.en_dir,
                          args.mask_dir)
    print(f"indexed {len(samples)} samples")
    train_idx, val_idx = grouped_split(samples, cfg.val_split,
                                       cfg.split_seed)
    print(f"train/val: {len(train_idx)}/{len(val_idx)}")
    n_proc, proc_id = mesh.data_count(), mesh.data_index()
    if n_proc > 1:
        # The split is the same on every process (same seed, same
        # listing); a decode failure gives a zero sample, not a dropped
        # batch (data/pipeline.py), so the shards stay aligned.
        def shard(idx):
            per = len(idx) // n_proc
            return idx[proc_id * per:(proc_id + 1) * per]
        train_idx, val_idx = shard(train_idx), shard(val_idx)
    text_embed_fn = None
    if cfg.text_encoder == "sbert":
        from vae_gan_mark_tpu_torch.data.text_embed import make_text_embedder
        text_embed_fn = make_text_embedder()
    common = dict(batch_size=cfg.batch_size // n_proc, seed=args.seed,
                  num_workers=args.num_workers, text_embed_fn=text_embed_fn,
                  **extra)
    train_data = loader(cfg, samples, train_idx, shuffle=True,
                        drop_last=True, **common)
    val_data = loader(cfg, samples, val_idx, shuffle=False,
                      drop_last=n_proc > 1, **common) if val_idx else None
    return train_data, val_data


def main(argv=None):
    import torch

    from vae_gan_mark_tpu_torch.config import VariantConfig
    from vae_gan_mark_tpu_torch.parallel import distributed, mesh
    from vae_gan_mark_tpu_torch.train.loop import Trainer
    from vae_gan_mark_tpu_torch.utils.debug import enable_nan_debugging

    args = build_parser().parse_args(argv)
    overrides = parse_overrides(VariantConfig, args.set)
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    cfg = get_config(args.variant, **overrides)
    several = (args.num_processes
               or int(os.environ.get("WORLD_SIZE") or 1)) > 1
    if args.no_mesh and several:
        raise SystemExit("--no-mesh runs one process; it cannot run with "
                         "--num-processes > 1")
    if args.multi_step > 1 and several:
        raise SystemExit("--multi-step > 1 runs one process (as the JAX "
                         "package's multi step); use --multi-step 1 with "
                         "several processes")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    device = torch.device(args.device)
    if not args.no_mesh:
        device = distributed.initialize(args.coordinator, args.num_processes,
                                        args.process_id, device=device)
    if cfg.batch_size % mesh.data_count():
        raise SystemExit(f"--batch-size {cfg.batch_size} does not split "
                         f"over {mesh.data_count()} processes")
    if args.debug_nans:
        enable_nan_debugging()

    if args.synthetic:
        train_data, val_data = synthetic_sources(cfg, args, device)
    else:
        train_data, val_data = disk_sources(cfg, args, device)

    trainer = Trainer(cfg, train_data, val_data, workdir=args.workdir,
                      seed=args.seed, device=device,
                      profile_dir=args.profile_dir,
                      multi_step=args.multi_step)
    best = trainer.fit()
    print(f"done; best val recon: {best:.4f}")
    trainer.logger.finish()
    distributed.shutdown()


if __name__ == "__main__":
    main()
