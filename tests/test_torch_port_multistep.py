"""``multi_step`` and ``remat_encoder`` in the port, on the CPU at the tiny
geometry of tests/test_train_fast.py.

On the CPU a multi step runs its K steps eagerly (the card replays a CUDA
graph of one step: tests/test_torch_port_gpu.py and ``chip_smoke.py``
phase 9), so it must equal the single-step driver bit for bit:

* ``Trainer(multi_step=4)`` over 10 batches an epoch (2 groups and a
  2-batch leftover), 6 val batches (a group and a 2-batch leftover), the
  BiGRU's dropout on: parameters, BatchNorm statistics, ``u``, Adam's
  state and the epoch records equal the ``multi_step=1`` Trainer's.
* Val batches keep their global indices (the generators' seeds), and the
  val triplets come from val batch 0 only.
* A checkpoint written with K=4 resumes with K=1 and one written with K=1
  resumes with K=4, each equal to an uninterrupted run.
* A checkpoint of the card's capturable Adam (step counts and rate on the
  card) loads into the CPU's plain Adam and back.

Against the JAX ``Trainer(multi_step=4)``: 2 epochs of 4 train batches (a
scanned group each) and 4 val batches (a scanned group) with seeded
``eps`` and the BiGRU's dropout at 0: the KL weight and learning rates
equal, the other record values within rtol 1e-2, atol 1e-6. Both sides
are float32 and differ in sum order, which Adam and the GAN's coupled
updates amplify: the largest reading is 5.2e-3 (train/kl_loss in epoch 2,
where the KL weight is 1e-7 and nothing holds mu and logvar back); with 2
epochs of 8 steps a D loss of 0.004 read 2.9e-2. A wrong batch, seed or
step count moves the records by 1e-1 or more.

``remat_encoder``: one train step with the encoder rematerialised equals
the step without it bit for bit (metrics, parameters and BatchNorm running
statistics); the running statistics move once, and would move twice
without the recompute's freeze.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.data.synthetic import (
    SyntheticPatchDataset as JaxSyntheticPatchDataset)
from vae_gan_mark_tpu.models import vaegan as jax_vaegan
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.train.loop import Trainer as JaxTrainer
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
from vae_gan_mark_tpu_torch.models import VGG16Features
from vae_gan_mark_tpu_torch.models import vaegan as port_vaegan
from vae_gan_mark_tpu_torch.ops.norms import BatchNorm
from vae_gan_mark_tpu_torch.train import step as step_module
from vae_gan_mark_tpu_torch.train.loop import Trainer
from vae_gan_mark_tpu_torch.train.state import (
    create_train_state, init_state_dicts, load_optimizer_state, make_adam)
from vae_gan_mark_tpu_torch.train.step import (
    batch_to_device, build_train_step)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, init_vgg_state_dict,
    state_dict_from_jax, vgg_state_dict_from_jax)

from torch_port_common import TINY

BATCH = 2
CFG = dict(TINY, batch_size=BATCH, **{"scheduler.patience": 0,
                                      "scheduler.threshold": 0.5})
UNTIMED = ("time", "train/images_per_sec")


def sources(cfg, steps=10, val_batches=6):
    train_ds = SyntheticPatchDataset(cfg, 40, seed=0)
    val_ds = SyntheticPatchDataset(cfg, 2 * val_batches, seed=1)

    def train_data(epoch):
        for i in range(steps):
            yield train_ds.batch(BATCH, i + steps * epoch)

    def val_data(epoch):
        for i in range(val_batches):
            yield val_ds.batch(BATCH, i)

    return train_data, val_data


def records(workdir, name="v2"):
    with open(os.path.join(workdir, f"{name}.metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in UNTIMED} for line in f]


def state_tensors(state):
    out = {f"G.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"D.{k}": v
                for k, v in state.discriminator.state_dict().items()})
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, entry in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v for k, v in entry.items()})
    return out


def assert_same_state(a, b):
    sa, sb = state_tensors(a), state_tensors(b)
    assert sa.keys() == sb.keys() and sa
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    assert a.step == b.step


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg)
    workdir = str(tmp_path_factory.mktemp("k1"))
    trainer = Trainer(cfg, train_data, val_data, workdir, seed=0,
                      device="cpu")
    trainer.fit(2)
    return trainer, workdir


def test_multi_step_trainer_equals_sequential(sequential, tmp_path):
    seq, seq_dir = sequential
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg)
    trainer = Trainer(cfg, train_data, val_data, str(tmp_path), seed=0,
                      device="cpu", multi_step=4)
    trainer.fit(2)
    assert trainer.state.step == 20
    assert_same_state(trainer.state, seq.state)
    assert records(str(tmp_path)) == records(seq_dir)


def recording(monkeypatch):
    """Record the keys of every generator that the steps make (the loop's
    eager steps make theirs in ``step.eager_step``)."""
    calls = []

    def make_generator(device, *keys):
        calls.append(keys)
        return torch.Generator(device=device).manual_seed(
            step_module.derive_seed(*keys))

    monkeypatch.setattr(step_module, "make_generator", make_generator)
    return calls


def test_val_groups_keep_their_batch_indices(monkeypatch, tmp_path):
    """6 val batches with K=4: a group (indices 0-3) and a leftover (4, 5),
    each drawing from (seed, index, step) as the single-step driver does."""
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg)
    trainer = Trainer(cfg, train_data, val_data, str(tmp_path), seed=7,
                      device="cpu", multi_step=4)
    trainer.state.step = 13
    calls = recording(monkeypatch)
    multi = trainer.validate(0)
    assert calls == [(7, i, 13) for i in range(6)]
    trainer.multi_step = 1
    assert trainer.validate(0) == multi
    assert calls[6:] == calls[:6]


def test_triplets_come_from_val_batch_zero(monkeypatch, tmp_path):
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg)
    logged = []
    for k in (1, 4):
        trainer = Trainer(cfg, train_data, val_data, str(tmp_path / str(k)),
                          seed=0, device="cpu", multi_step=k)
        monkeypatch.setattr(trainer.logger, "log_images",
                            lambda triplets, step: logged.append(triplets))
        trainer.validate(0)
    single, multi = logged
    first = next(val_data(0))
    # The single-step driver fills up to 16 from consecutive batches; the
    # multi step takes batch 0's rows only.
    assert len(single) == 6 * BATCH and len(multi) == BATCH
    for i, (ru, en, fake, caption) in enumerate(multi):
        np.testing.assert_array_equal(ru, first["ru"][i])
        np.testing.assert_array_equal(en, first["en"][i])
        np.testing.assert_array_equal(fake, single[i][2])
        assert caption == single[i][3]


@pytest.mark.parametrize("first,second", [(4, 1), (1, 4)],
                         ids=["k4_then_k1", "k1_then_k4"])
def test_checkpoint_resumes_across_multi_step(sequential, tmp_path, first,
                                              second):
    seq, seq_dir = sequential
    cfg = get_config("v2", **CFG)
    train_data, val_data = sources(cfg)
    Trainer(cfg, train_data, val_data, str(tmp_path), seed=0, device="cpu",
            multi_step=first).fit(1)
    resumed = Trainer(cfg, train_data, val_data, str(tmp_path), seed=0,
                      device="cpu", multi_step=second)
    assert resumed.epoch == 1 and resumed.state.step == 10
    resumed.fit(2)
    assert_same_state(resumed.state, seq.state)
    assert records(str(tmp_path)) == records(seq_dir)


def test_capturable_adam_checkpoint_loads_into_a_plain_adam():
    """A capturable Adam's state dict (as the card writes it: float32 step
    counts beside the parameters, a rate tensor, ``capturable`` set) loads
    into a plain Adam with the steps on the CPU and a float rate, and a
    plain one's into an Adam holding a rate tensor, which keeps its own
    tensor object (a captured graph reads it)."""
    cfg = get_config("v2", **TINY)
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_adam([p], 1e-4, cfg, torch.device("cpu"))
    p.grad = torch.full((3,), 0.5)
    opt.step()
    saved = opt.state_dict()
    card_like = {"state": {0: dict(saved["state"][0],
                                   step=saved["state"][0]["step"].clone())},
                 "param_groups": [dict(saved["param_groups"][0],
                                       capturable=True,
                                       lr=torch.tensor(3e-5))]}
    plain = make_adam([torch.nn.Parameter(torch.ones(3))], 1e-4, cfg,
                      torch.device("cpu"))
    load_optimizer_state(plain, card_like)
    group = plain.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)
    assert group["lr"] == pytest.approx(3e-5)
    (state,) = plain.state.values()
    assert state["step"].device.type == "cpu" and float(state["step"]) == 1
    assert torch.equal(state["exp_avg"], saved["state"][0]["exp_avg"])

    rate = torch.tensor(1e-4)
    holder = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=rate)
    load_optimizer_state(holder, saved)
    assert holder.param_groups[0]["lr"] is rate
    assert float(rate) == pytest.approx(1e-4)


# ------------------------------------------------------ against JAX
def with_eps(batch, seed, z_ch):
    batch = dict(batch)
    batch["eps"] = np.random.default_rng(seed).normal(
        0, 1, (len(batch["text"]), 1, 1, z_ch)).astype(np.float32)
    return batch


def jax_comparable_sources(dataset_cls, cfg):
    """4 train batches an epoch and 4 val batches (a group of 4 each), every
    batch with a seeded eps; the val batches are one batch four times, so
    that the JAX eval step's noise can be fixed to its eps."""
    train_ds = dataset_cls(cfg, 8, seed=0)
    val_batch = with_eps(dataset_cls(cfg, 4, seed=1).batch(4, 0), 99,
                         cfg.z_ch)

    def train_data(epoch):
        for i in range(4):
            yield with_eps(train_ds.batch(4, i + 4 * epoch), 10 * epoch + i,
                           cfg.z_ch)

    def val_data(epoch):
        for _ in range(4):
            yield val_batch

    return train_data, val_data, val_batch


def test_multi_step_trainer_matches_jax(tmp_path):
    overrides = dict(TINY, char_rnn_dropout=0.0, batch_size=4,
                     **{"scheduler.patience": 0, "scheduler.threshold": 0.5})
    jcfg = jax_get_config("v2", **overrides)
    train_data, val_data, val_batch = jax_comparable_sources(
        JaxSyntheticPatchDataset, jcfg)

    def fixed_noise(rng, mu, logvar):
        return (mu.astype(jnp.float32) + val_batch["eps"]
                * jnp.exp(0.5 * logvar.astype(jnp.float32))).astype(mu.dtype)

    jax_dir = str(tmp_path / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vaegan, "reparameterize", fixed_noise)
        jax_trainer = JaxTrainer(jcfg, train_data, val_data, jax_dir, seed=0,
                                 use_mesh=False, multi_step=4)
        s = jax_trainer.state
        numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        init = (numpy_tree(s.g_params), numpy_tree(s.g_batch_stats),
                numpy_tree(s.d_params), numpy_tree(s.d_spectral))
        jax_trainer.fit(2)

    cfg = get_config("v2", **overrides)
    train_data, val_data, _ = jax_comparable_sources(SyntheticPatchDataset,
                                                     cfg)
    port_dir = str(tmp_path / "port")
    trainer = Trainer(
        cfg, train_data, val_data, port_dir, seed=0, device="cpu",
        init=(state_dict_from_jax(init[0], init[1], cfg),
              discriminator_state_dict_from_jax(init[2], init[3])),
        vgg_state_dict=vgg_state_dict_from_jax(
            numpy_tree(load_vgg_params())), multi_step=4)
    trainer.fit(2)
    assert trainer.state.step == 8
    got, ref = records(port_dir), records(jax_dir)
    assert len(got) == len(ref) == 2
    exact = ("epoch", "train_params/current_kl_weight",
             "learning_rate/generator", "learning_rate/discriminator")
    readings = {}
    for epoch, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        for key in r:
            if key in exact:
                assert g[key] == r[key], (epoch, key)
            else:
                readings[(epoch, key)] = (abs(g[key] - r[key]), r[key])
    for (epoch, key), (diff, value) in readings.items():
        assert diff <= 1e-2 * abs(value) + 1e-6, (epoch, key, diff, value)


# ------------------------------------------------------------- remat
def one_step(remat, freeze=True):
    cfg = get_config("v2", **TINY, remat_encoder=remat)
    g, d = init_state_dicts(cfg, seed=0)
    state = create_train_state(cfg, g, d, device="cpu")
    vgg = VGG16Features()
    vgg.load_state_dict(init_vgg_state_dict(2))
    batch = batch_to_device(SyntheticPatchDataset(cfg, 4, seed=3).batch(4, 0),
                            "cpu")
    with contextlib.ExitStack() as stack:
        if not freeze:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(port_vaegan, "_recompute_contexts", lambda: (
                contextlib.nullcontext(), contextlib.nullcontext()))
        updates = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: updates.append(mod))
            for m in state.generator.style_vae_encoder_module.modules()
            if isinstance(m, BatchNorm)]
        state, metrics = build_train_step(cfg)(
            state, vgg, batch, torch.Generator().manual_seed(5), 1e-3)
        for h in hooks:
            h.remove()
    return state, metrics, len(updates) // max(len(hooks), 1)


def test_remat_encoder_leaves_the_step_as_it_is():
    plain, m_plain, forwards_plain = one_step(False)
    remat, m_remat, forwards_remat = one_step(True)
    # The encoder ran twice under remat (the recompute), once without.
    assert (forwards_plain, forwards_remat) == (1, 2)
    assert m_plain.keys() == m_remat.keys()
    for key in m_plain:
        assert torch.equal(m_plain[key], m_remat[key]), key
    a = state_tensors(plain)
    b = state_tensors(remat)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    # Without the freeze the recompute moves the running statistics a
    # second time.
    unfrozen, _, _ = one_step(True, freeze=False)
    moved_twice = state_tensors(unfrozen)
    assert any(not torch.equal(a[k], moved_twice[k])
               for k in a if "running_mean" in k and "style_vae" in k)
