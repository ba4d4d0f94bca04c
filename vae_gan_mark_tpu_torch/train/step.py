"""The GAN train step and the eval step (the JAX package's ``train/step.py``).

``build_train_step(cfg)`` returns ``step(state, vgg, batch, generator,
kl_weight) -> (state, metrics)``, the reference's per-batch schedule:

1. One generator forward in train mode. Its graph is kept and its backward
   runs once, on the G loss; BatchNorm's running statistics advance once,
   here.
2. The discriminator update on real images and ``fake.detach()``:
   ``loss_D = 0.5 * (hinge_d_real + hinge_d_fake)``, one Adam step, no
   clipping. With ``cfg.fused_disc_forward`` real and fake go through one
   concatenated forward (InstanceNorm is per sample), so the spectral ``u``
   advance once; otherwise two forwards advance them twice.
3. The generator update against the updated discriminator: its forward on
   ``fake`` advances ``u`` again, and its parameters take no gradient in
   this phase. ``loss_G = recon_weight * L1 + kl_weight * KL + gan_weight *
   hinge_g + perc_weight * perceptual``; G's gradient is clipped to the
   global norm, then one Adam step.

``generator`` is a ``torch.Generator`` on the batch's device: the
reparameterisation noise (unless ``batch["eps"]`` injects it) and the
BiGRU's dropout draw from it. ``kl_weight`` is an argument of every call, so
KL annealing needs no rebuild. Metrics: ``loss_G, loss_D, recon, kl, gan_g,
perc`` as 0-d tensors.

``build_eval_step(cfg)`` returns ``step(state, vgg, batch, generator,
kl_weight) -> (metrics, fake)``, the JAX eval step's signature: G in eval
mode, ``recon, kl, psnr, masked_l1, mark_recovery``, and with
``cfg.full_loss_val`` also ``gan_g, perc, loss_G, loss_D`` from a
discriminator that does not advance ``u``.

``build_multi_train_step(cfg)`` and ``build_multi_eval_step(cfg)`` run K
steps per call (the JAX package's ``multi_step``). K steps equal K single
steps: step ``s`` draws from a generator seeded from ``(seed, s)``, val
batch ``i`` after step ``s`` from ``(seed, i, s)``, as the epoch driver's
single steps do. On the card each step is a replay of a CUDA graph of the
single step (``train/graphs.py``), captured at the first call that finds
the step warm (run eagerly on that batch signature in this process) and,
for training, both Adams' state present; until then, and for a batch that
does not fit the graph, the steps run eagerly. On the CPU they always run
eagerly. ``kl_weight`` may be a float or a 0-d float32 tensor: the step
multiplies by it either way, with the same result for a float32 value.

Precision: G's convolutions run in the compute dtype. The discriminator
computes in float32 in both modes, as the JAX package's does, and the JAX
package runs its float32 work (D, the GRU, their gradients) at HIGH or
HIGHEST precision; so TF32 stays off for the whole step, backward included.
BatchNorm statistics, the KL term and the losses are float32.

In a process group (``parallel/``, one process per card, each data index
with its rows of the global batch) each network's gradients are averaged
over the data indices, with one all-reduce, before clipping and its Adam
step, and the metrics of both steps leave them as their mean over the data
group; with a generator partitioned over the model axis
(``mesh.partition_params``) the whole parameters' gradients are averaged
over every process and the blocks' over their data group (a second
all-reduce), and the clip's norm sums the blocks' norms over the model
group (``train/state.py:clip_by_global_norm_``); with
BatchNorm's statistics, the noise and the dropout masks taken over the
global batch (``parallel/mesh.py``), N processes compute the step of one
process on the global batch. The multi steps refuse a process group: their
graphs would capture collectives.

With ``cfg.conditional_disc`` every discriminator forward also takes the
batch's ``text`` as its ``cond`` (the fused forward the text twice, once for
the real and once for the fake half), as the JAX step does.

A batch is a dict of tensors on one device: ``ru``, ``en`` (B, H, W, 3),
``mask`` (B, H, W, 1) float32, ``text`` (B, L) int64 tokens or
(B, sbert_dim) float32 embeddings, optionally ``eps`` (B, 1, 1, z_ch);
``batch_to_device`` makes one from numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.eval import mark_recovery_rate, masked_l1
from vae_gan_mark_tpu_torch.losses import (
    hinge_d_fake, hinge_d_real, hinge_g, kl_divergence, l1_loss,
    perceptual_loss)
from vae_gan_mark_tpu_torch.models.vgg import VGG16Features
from vae_gan_mark_tpu_torch.ops.precision import precision_scope, torch_dtype
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.parallel import mesh
from vae_gan_mark_tpu_torch.train.graphs import (
    CapturedStep, is_warm, mark_warm)
from vae_gan_mark_tpu_torch.train.state import (
    TrainState, clip_by_global_norm_)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def derive_seed(*keys: int) -> int:
    """A 63-bit seed from a tuple of non-negative integers."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_generator(device: torch.device, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(*keys))


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: Union[str, torch.device]) -> Batch:
    """numpy batch -> tensors on ``device`` (``as_batch_tensor``)."""
    out = {}
    for key in ("ru", "en", "mask", "text", "eps"):
        if key in batch:
            value = torch.from_numpy(np.ascontiguousarray(batch[key]))
            out[key] = as_batch_tensor(key, value).to(device)
    return out


def _g_loss(cfg: VariantConfig, kl_weight, recon_l, kl, gan, perc):
    return (cfg.recon_weight * recon_l + kl_weight * kl
            + cfg.gan_weight * gan + cfg.perc_weight * perc)


def build_train_step(cfg: VariantConfig):
    dtype = torch_dtype(cfg.compute_dtype)

    def step(state: TrainState, vgg: VGG16Features, batch: Batch,
             generator: torch.Generator,
             kl_weight) -> Tuple[TrainState, Metrics]:
        g_model, d_model = state.generator, state.discriminator
        g_model.train()
        d_model.train()
        real = batch["en"]
        # The conditional D judges real and fake against the same text.
        cond = batch["text"] if cfg.conditional_disc else None
        with precision_scope(torch.float32):
            # 1. Generator forward; its backward runs once, in phase 3.
            fake, mu, logvar = g_model(batch["ru"], batch["mask"],
                                       batch["text"], eps=batch.get("eps"),
                                       generator=generator)

            # 2. Discriminator update.
            fake_sg = fake.detach()
            if cfg.fused_disc_forward:
                preds = d_model(torch.cat([real, fake_sg]).to(dtype),
                                None if cond is None
                                else torch.cat([cond, cond]))
                real_preds, fake_preds = preds.chunk(2)
            else:
                real_preds = d_model(real.to(dtype), cond)
                fake_preds = d_model(fake_sg.to(dtype), cond)
            loss_d = 0.5 * (hinge_d_real(real_preds)
                            + hinge_d_fake(fake_preds))
            state.opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            mesh.average_gradients_(d_model.parameters())
            state.opt_d.step()

            # 3. Generator update against the updated discriminator.
            d_model.requires_grad_(False)
            try:
                fake_preds = d_model(fake.to(dtype), cond)
                recon_l = l1_loss(fake, real)
                kl = kl_divergence(mu, logvar)
                gan = hinge_g(fake_preds)
                perc = perceptual_loss(vgg, fake, real)
                loss_g = _g_loss(cfg, kl_weight, recon_l, kl, gan, perc)
                state.opt_g.zero_grad(set_to_none=True)
                loss_g.backward()
            finally:
                d_model.requires_grad_(True)
            mesh.average_gradients_(g_model.parameters())
            clip_by_global_norm_(g_model.parameters(), cfg.grad_clip_norm)
            state.opt_g.step()
        state.step += 1
        metrics = {"loss_G": loss_g, "loss_D": loss_d, "recon": recon_l,
                   "kl": kl, "gan_g": gan, "perc": perc}
        return state, mesh.mean_over_processes(
            {k: v.detach() for k, v in metrics.items()})

    return step


def build_eval_step(cfg: VariantConfig):
    dtype = torch_dtype(cfg.compute_dtype)

    def step(state: TrainState, vgg: VGG16Features, batch: Batch,
             generator: torch.Generator,
             kl_weight) -> Tuple[Metrics, torch.Tensor]:
        g_model, d_model = state.generator, state.discriminator
        g_model.eval()
        real, mask = batch["en"], batch["mask"]
        with torch.no_grad(), precision_scope(torch.float32):
            fake, mu, logvar = g_model(batch["ru"], mask, batch["text"],
                                       eps=batch.get("eps"),
                                       generator=generator)
            recon_l = l1_loss(fake, real)
            kl = kl_divergence(mu, logvar)
            mse = torch.mean(torch.square(fake - real.float()))
            metrics = {
                "recon": recon_l, "kl": kl,
                "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-10)),
                "masked_l1": masked_l1(fake, real, mask),
                "mark_recovery": mark_recovery_rate(fake, real, mask)}
            if cfg.full_loss_val:
                cond = batch["text"] if cfg.conditional_disc else None
                fake_preds = d_model(fake.to(dtype), cond, update_sn=False)
                real_preds = d_model(real.to(dtype), cond, update_sn=False)
                gan = hinge_g(fake_preds)
                perc = perceptual_loss(vgg, fake, real)
                metrics.update({
                    "gan_g": gan, "perc": perc,
                    "loss_G": _g_loss(cfg, kl_weight, recon_l, kl, gan, perc),
                    "loss_D": 0.5 * (hinge_d_real(real_preds)
                                     + hinge_d_fake(fake_preds))})
        return mesh.mean_over_processes(metrics), fake

    return step


def _refuse_process_group() -> None:
    if mesh.active():
        raise RuntimeError("multi_step > 1 runs one process without a "
                           "process group (as the JAX package's multi step "
                           "runs one process); use multi_step=1")


def _adam_ready(state: TrainState) -> bool:
    """Both Adams hold state for every parameter they update: a capture
    must not record their lazy initialisation."""
    return all(opt.state.get(p) for opt in (state.opt_g, state.opt_d)
               for group in opt.param_groups for p in group["params"])


class _Replay:
    """The graph of one multi step: captured once, for the state and VGG
    it was captured with and one batch signature."""

    def __init__(self, kind: str, cfg: VariantConfig):
        self.kind = kind
        # The GRU kernels' host work is done before a capture, for configs
        # whose generator runs them (the char text paths).
        self.hidden = (cfg.char_rnn_hidden if cfg.text_encoder != "sbert"
                       else None)
        self.graph: Optional[CapturedStep] = None
        self.owner: Tuple = ()

    def get(self, state: TrainState, vgg: VGG16Features, batch: Batch,
            capture) -> Optional[CapturedStep]:
        """The graph for this call, captured now with ``capture`` if the
        step is warm (and, for training, Adam's state is there); None when
        the call runs eagerly."""
        if batch["ru"].device.type != "cuda":
            return None
        if self.graph is None:
            if not is_warm(self.kind, batch) or (
                    self.kind == "train" and not _adam_ready(state)):
                return None
            rows = batch["ru"].shape[0]
            if self.hidden is not None:
                gru.KERNEL.prepare(rows, self.hidden)
                if self.kind == "train":
                    gru.BACKWARD_KERNEL.prepare(rows, self.hidden)
            self.graph = CapturedStep(capture, batch)
            self.owner = (state, vgg)
        if self.owner[0] is not state or self.owner[1] is not vgg:
            raise ValueError("this multi step's graph was captured for "
                             "another train state; build a new multi step "
                             "for this one")
        return self.graph if self.graph.fits(batch) else None


def build_multi_train_step(cfg: VariantConfig):
    """``step(state, vgg, batches, seed, kl_weight, sums=None) -> (state,
    sums)``: the train steps on ``batches`` in order, step ``s`` with a
    generator seeded from ``(seed, s)``. Each step's metrics are added
    into ``sums`` as they come (it starts as the first step's), so the
    result is K times the steps' mean, which the JAX package's multi step
    returns and its epoch driver weights by K, and an epoch's sums are the
    sequential driver's bit for bit."""
    single = build_train_step(cfg)
    replay = _Replay("train", cfg)

    def step(state: TrainState, vgg: VGG16Features, batches: Sequence[Batch],
             seed: int, kl_weight,
             sums: Optional[Metrics] = None) -> Tuple[TrainState, Metrics]:
        _refuse_process_group()

        def capture(inputs, generator, kl):
            step0 = state.step
            _, metrics = single(state, vgg, inputs, generator, kl)
            state.step = step0
            return metrics

        for batch in batches:
            graph = replay.get(state, vgg, batch, capture)
            if graph is not None:
                metrics = graph.replay(batch, derive_seed(seed, state.step),
                                       kl_weight)
                state.step += 1
            else:
                device = batch["ru"].device
                state, metrics = single(state, vgg, batch, make_generator(
                    device, seed, state.step), kl_weight)
                if device.type == "cuda":
                    mark_warm("train", batch)
            # A replay's outputs are overwritten by the next replay.
            sums = ({k: v.clone() for k, v in metrics.items()} if sums is None
                    else {k: sums[k] + metrics[k] for k in sums})
        return state, sums

    return step


def build_multi_eval_step(cfg: VariantConfig):
    """``step(state, vgg, batches, idxs, seed, kl_weight) -> (metrics,
    fake0)``: the eval steps on ``batches``, the one at val-batch index
    ``idxs[j]`` with a generator seeded from ``(seed, idxs[j],
    state.step)``; ``metrics`` holds each batch's metrics, in order, and
    ``fake0`` the first batch's generated patches, as the JAX package's
    multi eval step returns them."""
    single = build_eval_step(cfg)
    replay = _Replay("eval", cfg)

    def step(state: TrainState, vgg: VGG16Features, batches: Sequence[Batch],
             idxs: Sequence[int], seed: int, kl_weight
             ) -> Tuple[List[Metrics], torch.Tensor]:
        _refuse_process_group()

        def capture(inputs, generator, kl):
            return single(state, vgg, inputs, generator, kl)

        out, fake0 = [], None
        for batch, idx in zip(batches, idxs):
            graph = replay.get(state, vgg, batch, capture)
            if graph is not None:
                metrics, fake = graph.replay(
                    batch, derive_seed(seed, idx, state.step), kl_weight)
                metrics = {k: v.clone() for k, v in metrics.items()}
                if fake0 is None:
                    fake0 = fake.clone()
            else:
                device = batch["ru"].device
                metrics, fake = single(state, vgg, batch, make_generator(
                    device, seed, idx, state.step), kl_weight)
                if device.type == "cuda":
                    mark_warm("eval", batch)
                if fake0 is None:
                    fake0 = fake
            out.append(metrics)
        return out, fake0

    return step
