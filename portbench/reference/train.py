"""Plain reference of the GAN train step (the published scripts' per-batch
schedule), of the validation pass, and of the readings that the training
cells compare.

One step: the generator's forward in train mode (noise and the BiGRU's
dropout drawn from a ``torch.Generator`` seeded from ``(trainer seed,
step)``); the discriminator's update on real images and the detached fake
(one forward of both when ``fused_disc_forward``), ``0.5 * (hinge_real +
hinge_fake)``, Adam; the generator's update against the updated
discriminator, ``recon * L1 + kl_w * KL + gan * hinge_g + perc * L1 of VGG
relu3_3 features``, its gradient clipped to the global norm, Adam. Adam is
written out: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``. Validation: the
generator in eval mode (running statistics, no dropout, the noise of val
batch ``i`` after step ``s`` from ``(trainer seed, i, s)``), the same
terms with the discriminator's power iteration held (``recon`` and ``kl``
alone where the configuration's ``full_loss_val`` is off), weighted by
batch size over the val batches.

The generator is the configuration's: ``arch`` is its reference module
(``reference/__init__.py``). ``run_steps`` returns what the comparison
reads: each checked epoch's mean terms, the gradient each optimizer
received at the first step (per leaf, its norm), each parameter's change
over all the steps (per leaf, its norm), the validation's terms, and the
generator's leaves of the text path. ``fault`` plants one: ``unchanged``
(no step moves a parameter or the optimizers' state), ``half_batch``
(every step sees the first half of its batch), ``reuse`` (every step of an
epoch sees the epoch's first batch), ``text_grad_x2`` (the text path's
gradients, ``arch.TEXT_PREFIXES``, doubled before the clip), ``val_half``
(validation over the first val batch alone).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import Discriminator, VGGHead, set_precision


def derive_seed(*keys: int) -> int:
    """A 63-bit seed from a tuple of non-negative integers (the seed of
    train step ``s`` is ``derive_seed(trainer_seed, s)``)."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def kl_weight(cfg: dict, epoch: int) -> float:
    """Linear KL anneal over ``kl_anneal_epochs``, as a float32 value."""
    n = cfg["kl_anneal_epochs"]
    if n <= 0 or epoch >= n:
        w = cfg["kl_weight"]
    else:
        w = cfg["start_kl_weight"] + (cfg["kl_weight"]
                                      - cfg["start_kl_weight"]) * (
            epoch / max(1, n - 1))
    return float(np.float32(w))


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas, eps: float = 1e-8):
        self.params = list(params)
        self.lr = float(np.float32(lr))
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale for g in grads]


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def kl_divergence(mu, logvar):
    per = -0.5 * torch.mean(1.0 + logvar - mu.square() - logvar.exp(),
                            dim=tuple(range(1, mu.dim())))
    return per.mean()


class Models:
    """G (``arch.Generator``), D and the VGG head loaded from the state
    dicts on ``device``."""

    def __init__(self, arch, cfg: dict, g_sd: Mapping, d_sd: Mapping,
                 vgg_sd: Mapping, device, precision: str = "float32"):
        self.arch = arch
        self.cfg = cfg
        self.g = arch.Generator(cfg)
        self.d = Discriminator()
        self.vgg = VGGHead()
        for m, sd in ((self.g, g_sd), (self.d, d_sd), (self.vgg, vgg_sd)):
            if sd is not None:
                m.load_state_dict(sd)
            m.to(device)
        set_precision((self.g, self.d, self.vgg), precision)
        self.g_params = dict(self.g.named_parameters())
        self.d_params = dict(self.d.named_parameters())


TERMS = ("loss_G", "loss_D", "recon", "kl", "gan_g", "perc")


def train_step(models: Models, opt_g: Adam, opt_d: Adam, batch: Mapping,
               generator, kl_w: float, half_batch: bool = False,
               text_grad_x2: bool = False, update: bool = True):
    """One step; returns (its losses and their terms, G's gradient as Adam
    got it, D's gradient)."""
    cfg, g_model, d_model = models.cfg, models.g, models.d
    if half_batch:
        rows = batch["ru"].shape[0] // 2
        batch = {k: v[:rows] for k, v in batch.items()}
    g_model.train()
    d_model.train()
    real = batch["en"]
    fake, mu, logvar = g_model(batch["ru"], batch["mask"], batch["text"],
                               generator=generator)
    fake_sg = fake.detach()
    # D takes the images as the compute dtype holds them.
    low = g_model.prec.low.out
    if cfg["fused_disc_forward"]:
        real_p, fake_p = d_model(low(torch.cat([real, fake_sg]))).chunk(2)
    else:
        real_p, fake_p = d_model(low(real)), d_model(low(fake_sg))
    loss_d = 0.5 * (torch.mean(F.relu(1.0 - real_p))
                    + torch.mean(F.relu(1.0 + fake_p)))
    d_params = list(models.d_params.values())
    grads_d = torch.autograd.grad(loss_d, d_params)
    if update:
        opt_d.step(grads_d)

    fake_p = d_model(low(fake))
    with torch.no_grad():
        target = models.vgg(real)
    perc = l1(models.vgg(fake), target)
    recon, kl, gan = l1(fake, real), kl_divergence(mu, logvar), \
        -torch.mean(fake_p)
    loss_g = (cfg["recon_weight"] * recon + kl_w * kl
              + cfg["gan_weight"] * gan + cfg["perc_weight"] * perc)
    g_params = list(models.g_params.values())
    grads_g = list(torch.autograd.grad(loss_g, g_params))
    if text_grad_x2:
        text = models.arch.TEXT_PREFIXES
        grads_g = [g * 2.0 if k.startswith(text) else g
                   for k, g in zip(models.g_params, grads_g)]
    grads_g = clip_by_global_norm(grads_g, cfg["grad_clip_norm"])
    if update:
        opt_g.step(grads_g)
    terms = {"loss_G": loss_g, "loss_D": loss_d, "recon": recon, "kl": kl,
             "gan_g": gan, "perc": perc}
    return {k: v.detach() for k, v in terms.items()}, grads_g, grads_d


@torch.no_grad()
def validate(models: Models, batches: Sequence[Mapping], trainer_seed: int,
             step: int, kl_w: float) -> Dict[str, float]:
    """The validation terms after ``step`` train steps, each the batch-size
    weighted mean over ``batches``."""
    cfg, g_model, d_model = models.cfg, models.g, models.d
    g_model.eval()
    low = g_model.prec.low.out
    sums: Dict[str, float] = {}
    rows = 0
    for idx, batch in enumerate(batches):
        gen = torch.Generator(device=batch["ru"].device).manual_seed(
            derive_seed(trainer_seed, idx, step))
        real = batch["en"]
        fake, mu, logvar = g_model(batch["ru"], batch["mask"], batch["text"],
                                   generator=gen)
        recon, kl = l1(fake, real), kl_divergence(mu, logvar)
        terms = {"recon": recon, "kl": kl}
        if cfg["full_loss_val"]:
            fake_p = d_model(low(fake), update=False)
            real_p = d_model(low(real), update=False)
            gan = -torch.mean(fake_p)
            perc = l1(models.vgg(fake), models.vgg(real))
            terms.update({
                "gan_g": gan, "perc": perc,
                "loss_G": cfg["recon_weight"] * recon + kl_w * kl
                + cfg["gan_weight"] * gan + cfg["perc_weight"] * perc,
                "loss_D": 0.5 * (torch.mean(F.relu(1.0 - real_p))
                                 + torch.mean(F.relu(1.0 + fake_p)))})
        n = batch["ru"].shape[0]
        rows += n
        for k, v in terms.items():
            sums[k] = sums.get(k, 0.0) + float(v) * n
    g_model.train()
    return {k: v / max(rows, 1) for k, v in sums.items()}


def run_steps(arch, cfg: dict, g_sd: Mapping, d_sd: Mapping,
              vgg_sd: Mapping, epochs: Sequence[Sequence[Mapping]],
              val_batches: Sequence[Mapping], trainer_seed: int, kl_w: float,
              device, precision: str = "float32",
              fault: Optional[str] = None) -> dict:
    """The checked epochs' steps from the given state, in order, step ``s``
    drawing from ``derive_seed(trainer_seed, s)``, then validation."""
    models = Models(arch, cfg, g_sd, d_sd, vgg_sd, device, precision)
    betas = (cfg["adam_b1"], cfg["adam_b2"])
    opt_g = Adam(models.g_params.values(), cfg["lr_g"], betas)
    opt_d = Adam(models.d_params.values(), cfg["lr_d"], betas)
    start = {k: v.detach().clone() for k, v in
             list(_prefixed(models).items())}
    losses, grad1 = [], {}
    step = 0
    for batches in epochs:
        sums = dict.fromkeys(TERMS, 0.0)
        for batch in batches:
            if fault == "reuse":
                batch = batches[0]
            gen = torch.Generator(device=device).manual_seed(
                derive_seed(trainer_seed, step))
            terms, grads_g, grads_d = train_step(
                models, opt_g, opt_d, batch, gen, kl_w,
                half_batch=fault == "half_batch",
                text_grad_x2=fault == "text_grad_x2",
                update=fault != "unchanged")
            for k in TERMS:
                sums[k] += float(terms[k])
            if step == 0:
                grad1 = {f"{net}.{k}": float(torch.linalg.vector_norm(g))
                         for net, names, grads in (
                             ("G", models.g_params, grads_g),
                             ("D", models.d_params, grads_d))
                         for k, g in zip(names, grads)}
            step += 1
        losses.append({k: v / len(batches) for k, v in sums.items()})
    change = {k: float(torch.linalg.vector_norm(v.detach() - start[k]))
              for k, v in _prefixed(models).items()}
    val = validate(models, val_batches[:1] if fault == "val_half"
                   else val_batches, trainer_seed, step, kl_w)
    text = [f"G.{k}" for k in models.g_params
            if k.startswith(arch.TEXT_PREFIXES)]
    return {"losses": losses, "grad1": grad1, "change": change, "val": val,
            "text_leaves": text}


def _prefixed(models: Models) -> Dict[str, torch.Tensor]:
    return {**{f"G.{k}": v for k, v in models.g_params.items()},
            **{f"D.{k}": v for k, v in models.d_params.items()}}
