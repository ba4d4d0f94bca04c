"""The epoch loop (the JAX package's ``train/loop.py``).

``Trainer.fit`` runs, per epoch:

* the train steps over a data source, a callable ``epoch -> iterator of
  batches`` (dicts with ``ru``, ``en``, ``mask``: NHWC float32 in [0, 1],
  ``text``: int tokens or float sentence embeddings, optionally ``eps``
  and the host-only ``raw_text``), with the epoch's annealed KL weight;
* validation with the config's eval step, and up to 16 val triplets with
  their target text as captions;
* ReduceLROnPlateau on the val reconstruction loss, for both optimizers;
* the ``best_model`` checkpoint when the val reconstruction improves and
  ``last_checkpoint`` every ``cfg.save_every`` epochs and at the last one;
* the metric record with the reference's schema (``train/*``, ``val/*``,
  ``learning_rate/*``); a non-finite epoch loss raises (the NaN guard).

With ``multi_step=K > 1`` the train batches go in groups of K through
``build_multi_train_step`` and the val batches in groups of K through
``build_multi_eval_step`` (on the card: CUDA-graph replays of one step,
``train/graphs.py``), as the JAX Trainer's ``multi_step`` does: K steps
equal K single steps, a trailing group of fewer than K batches runs as
single steps, val batches keep their global indices, and the val triplets
come from val batch 0 only. The single steps (``train/step.py:eager_step``)
warm no multi step's graph, so a trailing group is never captured. The
epoch's metric sums are the single-step driver's bit for bit (each group
adds its K steps' metrics, K times their mean, one by one).

A new ``Trainer`` on a workdir with a ``last_checkpoint`` resumes after its
epoch. Randomness does not live in the state: train step ``s`` draws its
noise and dropout from a ``torch.Generator`` seeded from ``(seed, s)`` and
val batch ``i`` after step ``s`` from ``(seed, i, s)`` (the JAX package
folds the same numbers into one key), so a resumed run draws what an
uninterrupted one does. Learning rates are held as float32 values, as
optax's injected hyperparameters are.

In a process group (``parallel/distributed.py``: one process per card,
each data source yielding this process's rows of every global batch, the
same number of batches on every process) the steps compute the global
batch's step (``train/step.py``) and their metrics are the processes'
means, so the plateau lowers the rates at the same epoch everywhere. Only
process 0 writes the metric record, the images and the checkpoints
(``train/checkpoint.py`` fences its saves with barriers); every process
resumes from the same checkpoint, and G and D are process 0's on every
process after set-up. ``multi_step > 1`` and device-resident synthetic data
are refused there, as the JAX package refuses them with several processes.

The weights: ``init=(g_state_dict, d_state_dict)``, or without it a fresh
init drawn from ``seed`` (``train/state.py:init_state_dicts``). The VGG
head: ``vgg_state_dict``, or ``train/state.py:vgg_state_dict()`` (ported
weights from ``tools/vgg16_features.npz`` when present, else a fixed-seed
random head; the JAX package's random head comes from ``PRNGKey(16)``,
which torch cannot reproduce, so without the file the perceptual loss
differs from the JAX package's).

Spans (``utils/profiling.py``): ``train.epoch`` over ``train_epoch`` and
``train.validate`` over ``validate`` (each the root of its call's spans),
``train.step`` and ``train.eval_step`` over each step the host issues
(``kind``: ``eager``, ``capture`` or ``replay``), ``train.prefetch_wait``
over each wait for a prefetched batch, ``train.epoch_read`` over the
epoch's one read of the device sums, and ``train.val_read`` over
validation's reads and its image log. The counters ``train.steps_eager``,
``train.steps_replayed`` and ``train.graph_captures`` count train and eval
steps alike.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.data.device_synthetic import (
    DeviceResidentSynthetic)
from vae_gan_mark_tpu_torch.models.vgg import VGG16Features
from vae_gan_mark_tpu_torch.ops.precision import torch_dtype
from vae_gan_mark_tpu_torch.parallel import mesh
from vae_gan_mark_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from vae_gan_mark_tpu_torch.train.metrics import MetricsLogger, NullLogger
from vae_gan_mark_tpu_torch.train.schedule import (
    PlateauState, kl_weight_for_epoch, plateau_step)
from vae_gan_mark_tpu_torch.train.state import (
    create_train_state, get_lr, init_state_dicts, set_lr,
    vgg_state_dict as default_vgg_state_dict)
from vae_gan_mark_tpu_torch.train.step import (
    build_eval_step, build_multi_eval_step, build_multi_train_step,
    build_train_step, eager_step)
from vae_gan_mark_tpu_torch.utils.profiling import span, trace

DataSource = Callable[[int], Iterator[dict]]
StateDict = Mapping[str, torch.Tensor]


def float32_value(x: float) -> float:
    return float(np.float32(x))


def to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def prefetch_to_device(iterator: Iterator[dict], put, size: int = 2):
    """Host -> device prefetch on a daemon thread with a bounded queue.

    The thread pulls batches and issues their copies while the caller's
    current step runs, so batch N+1's load and copy overlap step N. ``None``
    batches are dropped; an exception in the thread is raised in the
    caller; when the caller stops early the thread stops too.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def send(item) -> bool:
        # A bounded put that gives up once the caller has left, so the
        # thread never blocks holding copied batches.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if item is None:
                    continue
                if not send(put(item)):
                    return
            send(sentinel)
        except BaseException as e:  # raised again in the caller
            send(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with span("train.prefetch_wait"):
                item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # release the queued device batches
            q.get_nowait()


class Trainer:
    def __init__(self, cfg: VariantConfig, train_data: DataSource,
                 val_data: Optional[DataSource], workdir: str,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 init: Optional[Tuple[StateDict, StateDict]] = None,
                 vgg_state_dict: Optional[StateDict] = None,
                 logger: Optional[MetricsLogger] = None,
                 nan_guard: bool = True,
                 profile_dir: Optional[str] = None,
                 multi_step: int = 1):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer(device={str(device)!r}): no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.train_data = train_data
        self.val_data = val_data
        self.workdir = workdir
        self.seed = seed
        self.processes = mesh.data_count()
        self.is_main = mesh.process_index() == 0
        self.multi_step = max(int(multi_step), 1)
        if mesh.model_count() > 1:
            raise ValueError("the epoch driver trains on the data axis "
                             "alone, as the JAX package's does; its "
                             "checkpoints hold whole parameters")
        if mesh.active() and self.multi_step > 1:
            raise ValueError("multi_step > 1 runs in one process without a "
                             "process group, as the JAX package's multi "
                             "step does")
        if self.processes > 1 and isinstance(train_data,
                                             DeviceResidentSynthetic):
            raise ValueError("device-resident synthetic data holds the "
                             "whole set in one process; a multi-process "
                             "run loads each process's rows from the host")
        os.makedirs(workdir, exist_ok=True)
        # Every process sees the same metrics; process 0 writes them.
        if logger is None:
            logger = (MetricsLogger(workdir, run_name=cfg.name)
                      if self.is_main else NullLogger())
        self.logger = logger
        self.nan_guard = nan_guard
        self.profile_dir = profile_dir

        g_sd, d_sd = init if init is not None else init_state_dicts(cfg, seed)
        self.state = create_train_state(cfg, g_sd, d_sd, self.device)
        set_lr(self.state.opt_g, float32_value(cfg.lr_g))
        set_lr(self.state.opt_d, float32_value(cfg.lr_d))
        self.vgg = VGG16Features(torch_dtype(cfg.compute_dtype))
        self.vgg.load_state_dict(vgg_state_dict if vgg_state_dict is not None
                                 else default_vgg_state_dict())
        self.vgg.to(self.device)
        self.train_step = build_train_step(cfg)
        self.eval_step = build_eval_step(cfg)
        if self.multi_step > 1:
            self.multi_train_step = build_multi_train_step(cfg)
            self.multi_eval_step = build_multi_eval_step(cfg)

        self.epoch = 0
        self.best_val = float("inf")
        self.sched_g = PlateauState()
        self.sched_d = PlateauState()
        self._maybe_resume()
        mesh.replicate_(self.state.generator)
        mesh.replicate_(self.state.discriminator)

    # ------------------------------------------------------------------
    def _maybe_resume(self):
        meta = restore_checkpoint(self.workdir, "last_checkpoint", self.state)
        if meta is None:
            return
        self.epoch = meta["epoch"] + 1
        self.best_val = meta["best_val"]
        self.sched_g = meta["sched_g"]
        self.sched_d = meta["sched_d"]
        set_lr(self.state.opt_g, meta["lr_g"])
        set_lr(self.state.opt_d, meta["lr_d"])
        print(f"[resume] from epoch {meta['epoch']} "
              f"(best_val={self.best_val:.4f})")

    def _put(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A batch on the device: tensors already there pass untouched;
        numpy arrays go through pinned memory with a non-blocking copy."""
        out = {}
        for key, value in batch.items():
            if key == "raw_text":
                continue
            if isinstance(value, torch.Tensor):
                out[key] = value.to(self.device)     # no copy when there
                continue
            t = as_batch_tensor(key, torch.as_tensor(
                np.ascontiguousarray(value)))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    @staticmethod
    def _host_means(sums: Optional[dict], count: int) -> Dict[str, float]:
        """Device sums -> host means, with one transfer."""
        if not sums:
            return {}
        values = torch.stack(list(sums.values())).tolist()
        return {k: v / max(count, 1) for k, v in zip(sums, values)}

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        kl_w = float32_value(kl_weight_for_epoch(self.cfg, epoch))
        # Metric sums stay on the device and are read once an epoch.
        t0 = time.time()
        with span("train.epoch", epoch=epoch):
            if self.multi_step > 1:
                sums, steps, images = self._train_epoch_multi(epoch, kl_w)
            else:
                sums, steps, images = None, 0, 0
                for batch in prefetch_to_device(self.train_data(epoch),
                                                self._put):
                    sums = self._single_train_step(batch, kl_w, sums)
                    images += batch["ru"].shape[0]
                    steps += 1
            with span("train.epoch_read"):
                avg = self._host_means(sums, steps)
        images *= self.processes             # each process ran its rows
        dt = time.time() - t0
        if self.nan_guard and avg and not np.isfinite(avg["loss_G"]):
            raise FloatingPointError(
                f"non-finite generator loss in epoch {epoch} (localise it "
                f"with --debug-nans)")
        avg["images_per_sec"] = images / max(dt, 1e-9)
        avg["kl_weight"] = kl_w
        return avg

    def _single_train_step(self, batch: dict, kl_w: float,
                           sums: Optional[dict]) -> dict:
        self.state, metrics = eager_step(
            "train.step", self.train_step, self.state, self.vgg, batch,
            (self.seed, self.state.step), kl_w)
        return metrics if sums is None else {
            k: sums[k] + metrics[k] for k in sums}

    def _train_epoch_multi(self, epoch: int, kl_w: float) -> tuple:
        """The epoch in groups of K batches, each through the multi train
        step; a trailing group of fewer than K batches as single steps."""
        k = self.multi_step

        def grouped():
            group = []
            for batch in self.train_data(epoch):
                if batch is None:
                    continue
                group.append(batch)
                if len(group) == k:
                    yield group
                    group = []
            if group:
                yield group

        sums, steps, images = None, 0, 0
        for group in prefetch_to_device(
                grouped(), lambda g: [self._put(b) for b in g]):
            if len(group) == k:
                self.state, sums = self.multi_train_step(
                    self.state, self.vgg, group, self.seed, kl_w, sums)
            else:
                for batch in group:
                    sums = self._single_train_step(batch, kl_w, sums)
            steps += len(group)
            images += sum(b["ru"].shape[0] for b in group)
        return sums, steps, images

    def _caption(self, host_batch: dict, i: int, epoch: int) -> str:
        # The caption carries the target text, cut at 50 characters, as
        # the reference's does.
        raw_texts = host_batch.get("raw_text")
        if raw_texts is None:
            return f"Epoch {epoch + 1}"
        t = raw_texts[i]
        label = t[:50] + "..." if len(t) > 50 else t
        return f"Epoch {epoch + 1} | Target: '{label}'"

    def validate(self, epoch: int) -> dict:
        if self.val_data is None:
            return {}
        kl_w = float32_value(kl_weight_for_epoch(self.cfg, epoch))
        with span("train.validate", epoch=epoch):
            if self.multi_step > 1:
                return self._validate_multi(epoch, kl_w)
            return self._validate_single(epoch, kl_w)

    def _eager_eval_step(self, batch: dict, idx: int, kl_w: float):
        return eager_step("train.eval_step", self.eval_step, self.state,
                          self.vgg, batch, (self.seed, idx, self.state.step),
                          kl_w)

    def _validate_single(self, epoch: int, kl_w: float) -> dict:
        sums, n_samples = None, 0
        triplets = []
        for batch_idx, host_batch in enumerate(self.val_data(epoch)):
            if host_batch is None:
                continue
            batch = self._put(host_batch)
            metrics, fake = self._eager_eval_step(batch, batch_idx, kl_w)
            bsz = batch["ru"].shape[0]
            n_samples += bsz
            weighted = {k: v * bsz for k, v in metrics.items()}
            sums = weighted if sums is None else {
                k: sums[k] + weighted[k] for k in sums}
            if len(triplets) < 16 and self.is_main:
                with span("train.val_read"):
                    fake_np = fake.cpu().numpy()
                for i in range(min(bsz, 16 - len(triplets))):
                    triplets.append((to_numpy(host_batch["ru"][i]),
                                     to_numpy(host_batch["en"][i]),
                                     fake_np[i],
                                     self._caption(host_batch, i, epoch)))
        with span("train.val_read"):
            avg = self._host_means(sums, n_samples)
            if triplets:
                self.logger.log_images(triplets, step=epoch + 1)
        return avg

    def _validate_multi(self, epoch: int, kl_w: float) -> dict:
        """Validation in groups of K val batches through the multi eval
        step, a trailing group of fewer than K as single steps; every batch
        keeps its global index. The metrics equal the single-step
        validation's bit for bit (the same generators, the same
        batch-size weights, summed in the same order); the triplets come
        from val batch 0 only, as the JAX Trainer's do."""
        k = self.multi_step
        sums, n_samples = None, 0
        fake0, first_host = None, None
        group: list = []
        start = 0

        def flush(group, start):
            nonlocal sums, n_samples, fake0, first_host
            batches = [self._put(b) for b in group]
            idxs = list(range(start, start + len(group)))
            if len(group) == k:
                per_batch, fake = self.multi_eval_step(
                    self.state, self.vgg, batches, idxs, self.seed, kl_w)
            else:
                per_batch, fake = [], None
                for batch, idx in zip(batches, idxs):
                    metrics, f = self._eager_eval_step(batch, idx, kl_w)
                    per_batch.append(metrics)
                    fake = f if fake is None else fake
            for batch, metrics in zip(batches, per_batch):
                bsz = batch["ru"].shape[0]
                n_samples += bsz
                weighted = {key: v * bsz for key, v in metrics.items()}
                sums = weighted if sums is None else {
                    key: sums[key] + weighted[key] for key in sums}
            if start == 0:
                with span("train.val_read"):
                    fake0, first_host = fake.cpu().numpy(), group[0]

        for host_batch in self.val_data(epoch):
            if host_batch is None:
                continue
            group.append(host_batch)
            if len(group) == k:
                flush(group, start)
                start += k
                group = []
        if group:
            flush(group, start)

        with span("train.val_read"):
            avg = self._host_means(sums, n_samples)
            if fake0 is not None:
                triplets = [(to_numpy(first_host["ru"][i]),
                             to_numpy(first_host["en"][i]), fake0[i],
                             self._caption(first_host, i, epoch))
                            for i in range(min(fake0.shape[0], 16))]
                self.logger.log_images(triplets, step=epoch + 1)
        return avg

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None) -> float:
        epochs = epochs if epochs is not None else self.cfg.epochs
        first = self.epoch
        for epoch in range(first, epochs):
            if self.profile_dir and epoch == first + 1:
                with trace(self.profile_dir, f"epoch{epoch + 1}",
                           self.device):
                    self._fit_epoch(epoch, epochs)
            else:
                self._fit_epoch(epoch, epochs)
        return self.best_val

    def _fit_epoch(self, epoch: int, epochs: int) -> None:
        """One epoch: train, validate, log, plateau, saves."""
        cfg = self.cfg
        train_metrics = self.train_epoch(epoch)
        log = {
            "epoch": epoch + 1,
            "train/generator_loss": train_metrics.get("loss_G", 0.0),
            "train/discriminator_loss": train_metrics.get("loss_D", 0.0),
            "train/recon_loss": train_metrics.get("recon", 0.0),
            "train/kl_loss": train_metrics.get("kl", 0.0),
            "train/gan_loss_g": train_metrics.get("gan_g", 0.0),
            "train/perceptual_loss": train_metrics.get("perc", 0.0),
            "train/images_per_sec": train_metrics.get("images_per_sec", 0.0),
            "train_params/current_kl_weight": train_metrics.get("kl_weight", 0.0),
            "learning_rate/generator": get_lr(self.state.opt_g),
            "learning_rate/discriminator": get_lr(self.state.opt_d),
        }

        val_metrics = self.validate(epoch)
        val_recon = val_metrics.get("recon", float("inf"))
        if val_metrics:
            log["val/recon_loss"] = val_recon
            log["val/psnr"] = val_metrics.get("psnr", 0.0)
            log["val/masked_l1"] = val_metrics.get("masked_l1", 0.0)
            log["val/mark_recovery"] = val_metrics.get(
                "mark_recovery", 0.0)
            if cfg.full_loss_val:
                log["val/generator_loss"] = val_metrics.get("loss_G", 0.0)
                log["val/discriminator_loss"] = val_metrics.get(
                    "loss_D", 0.0)
                # The raw KL and the same average times the epoch's
                # annealed weight; val/kl_loss stays as the raw KL.
                kl_raw = val_metrics.get("kl", 0.0)
                log["val/kl_loss"] = kl_raw
                log["val/kl_loss_raw"] = kl_raw
                log["val/kl_loss_weighted"] = (
                    kl_raw * train_metrics.get("kl_weight", 0.0))
                log["val/gan_loss_g"] = val_metrics.get("gan_g", 0.0)
                log["val/perceptual_loss"] = val_metrics.get("perc", 0.0)
        self.logger.log(log, step=epoch + 1)

        # ReduceLROnPlateau on val recon.
        if cfg.scheduler is not None and val_metrics:
            for opt, sched in ((self.state.opt_g, self.sched_g),
                               (self.state.opt_d, self.sched_d)):
                set_lr(opt, float32_value(plateau_step(
                    cfg.scheduler, sched, val_recon, get_lr(opt))))

        if val_recon < self.best_val:
            self.best_val = val_recon
            self.logger.set_summary("best_val_recon_loss", self.best_val)
            best_path = self._save("best_model", epoch)
            self.logger.log_model_artifact(best_path, epoch + 1,
                                           self.best_val)
        # last_checkpoint every cfg.save_every epochs and at the last
        # one, so that resume and eval see the finished run.
        if ((epoch + 1) % max(cfg.save_every, 1) == 0
                or epoch == epochs - 1):
            self._save("last_checkpoint", epoch)

    def _save(self, name: str, epoch: int) -> str:
        return save_checkpoint(
            self.workdir, name, self.state, epoch, self.best_val,
            self.sched_g, self.sched_d,
            get_lr(self.state.opt_g), get_lr(self.state.opt_d))
