"""The port's epoch driver and what it stands on, against the JAX package,
on the CPU at the tiny geometry of tests/test_train_fast.py with the BiGRU's
dropout at 0: the schedules, the synthetic data sources, the checkpoints,
resume, the fresh init, and the whole ``Trainer`` against the JAX
``Trainer`` (``use_mesh=False``).

The Trainer comparison runs 3 epochs of 3 train steps and one val batch on
both sides, from the JAX Trainer's own init carried across by the weight
bridge, with v2's KL anneal and the plateau schedule at patience 0 and a
relative threshold of 0.5, so that it lowers both learning rates at every
epoch after the first. Every batch carries a seeded ``eps``: the JAX
train step uses it in place of its own noise. The JAX eval step drops it, so
its ``reparameterize`` is patched to use the val batch's ``eps`` (train
steps never call it). Tolerances, and why:

* The epoch records: rtol 3e-3, atol 1e-6. Both sides are float32 and
  differ in the sum order of some 40 convolutions, and Adam's first update
  turns rounding near its eps into parameter differences (see
  test_torch_port_train.py, whose rtol 1e-3 holds 3 steps and read 1.7e-4
  there). Over 9 steps the differences grow: read 8.6e-4 relative at most
  (val/kl_loss at epoch 3; the other keys 2.5e-4 or less).
* The KL weight, the learning rates and the epoch of ``best_model``: equal.
  The port holds learning rates as float32 values, as optax does.
"""

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
from vae_gan_mark_tpu.train import schedule as jax_schedule
from vae_gan_mark_tpu.train.loop import Trainer as JaxTrainer
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data.device_synthetic import (
    DeviceResidentSynthetic)
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
from vae_gan_mark_tpu_torch.train import schedule
from vae_gan_mark_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from vae_gan_mark_tpu_torch.train.loop import Trainer, prefetch_to_device
from vae_gan_mark_tpu_torch.train.state import (
    create_train_state, get_lr, init_state_dicts, set_lr)
from vae_gan_mark_tpu_torch.train.step import (
    batch_to_device, build_train_step)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)

from torch_port_common import TINY

TRAIN = dict(TINY, char_rnn_dropout=0.0, batch_size=4,
             **{"scheduler.patience": 0, "scheduler.threshold": 0.5})
BATCH, STEPS, EPOCHS = 4, 3, 3
RECORD_TOL = dict(rtol=3e-3, atol=1e-6)
EXACT_KEYS = ("epoch", "train_params/current_kl_weight",
              "learning_rate/generator", "learning_rate/discriminator")
UNTIMED = ("time", "train/images_per_sec")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def with_eps(batch, seed, z_ch):
    batch = dict(batch)
    batch["eps"] = np.random.default_rng(seed).normal(
        0, 1, (len(batch["text"]), 1, 1, z_ch)).astype(np.float32)
    return batch


def sources(dataset_cls, cfg):
    """Train: 3 batches an epoch from 12 samples; val: one batch; every
    batch with its own seeded eps."""
    train_ds = dataset_cls(cfg, STEPS * BATCH, seed=0)
    val_batch = with_eps(dataset_cls(cfg, BATCH, seed=1).batch(BATCH, 0),
                         99, cfg.z_ch)

    def train_data(epoch):
        for i in range(STEPS):
            yield with_eps(train_ds.batch(BATCH, i), 10 * epoch + i,
                           cfg.z_ch)

    def val_data(epoch):
        yield val_batch

    return train_data, val_data, val_batch


def records(workdir):
    with open(os.path.join(workdir, "v2.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def checkpoint_meta(workdir, name):
    with open(os.path.join(workdir, name, "host_meta.json")) as f:
        return json.load(f)


def full_state(state):
    return {**{f"G.{k}": v for k, v in state.generator.state_dict().items()},
            **{f"D.{k}": v for k, v in
               state.discriminator.state_dict().items()}}


def assert_states_equal(a, b):
    sa, sb = full_state(a), full_state(b)
    assert set(sa) == set(sb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------- (f), (g)
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer over 3 epochs: its init (numpy trees), its VGG and
    its workdir."""
    jcfg = jax_get_config("v2", **TRAIN)
    train_data, val_data, val_batch = sources(JaxSyntheticPatchDataset, jcfg)

    def fixed_noise(rng, mu, logvar):
        return (mu.astype(jnp.float32) + val_batch["eps"]
                * jnp.exp(0.5 * logvar.astype(jnp.float32))).astype(mu.dtype)

    workdir = str(tmp_path_factory.mktemp("jax_trainer"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vaegan, "reparameterize", fixed_noise)
        trainer = JaxTrainer(jcfg, train_data, val_data, workdir, seed=0,
                             use_mesh=False)
        s = trainer.state
        init = (numpy_tree(s.g_params), numpy_tree(s.g_batch_stats),
                numpy_tree(s.d_params), numpy_tree(s.d_spectral))
        trainer.fit(EPOCHS)
    return dict(init=init, vgg=numpy_tree(load_vgg_params()),
                workdir=workdir)


def test_trainer_matches_jax_trainer(jax_run, tmp_path):
    cfg = get_config("v2", **TRAIN)
    g_params, g_stats, d_params, d_spectral = jax_run["init"]
    init = (state_dict_from_jax(g_params, g_stats, cfg),
            discriminator_state_dict_from_jax(d_params, d_spectral))
    train_data, val_data, _ = sources(SyntheticPatchDataset, cfg)
    trainer = Trainer(cfg, train_data, val_data, str(tmp_path), seed=0,
                      device="cpu", init=init,
                      vgg_state_dict=vgg_state_dict_from_jax(jax_run["vgg"]))
    trainer.fit(EPOCHS)
    assert trainer.state.step == EPOCHS * STEPS

    got, ref = records(str(tmp_path)), records(jax_run["workdir"])
    assert len(got) == len(ref) == EPOCHS
    for epoch, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        assert {"val/kl_loss_raw", "val/kl_loss_weighted"} <= set(g)
        for key in r:
            if key in UNTIMED:
                continue
            if key in EXACT_KEYS:
                assert g[key] == r[key], (epoch, key)
            else:
                np.testing.assert_allclose(g[key], r[key], **RECORD_TOL,
                                           err_msg=f"epoch {epoch}: {key}")
    # A record shows the rates its epoch trained with: the schedule lowers
    # them after epochs 2 and 3 (the first is an improvement on inf).
    lrs = [g["learning_rate/generator"] for g in got]
    assert lrs[0] == lrs[1] > lrs[2]
    for name in ("best_model", "last_checkpoint"):
        meta, ref_meta = (checkpoint_meta(d, name)
                          for d in (str(tmp_path), jax_run["workdir"]))
        assert meta["epoch"] == ref_meta["epoch"], name
        assert (meta["lr_g"], meta["lr_d"]) == (ref_meta["lr_g"],
                                                ref_meta["lr_d"]), name
    assert checkpoint_meta(str(tmp_path), "last_checkpoint")["lr_g"] < lrs[2]
    for ep in range(1, EPOCHS + 1):
        assert os.path.isfile(os.path.join(
            str(tmp_path), f"val_images_ep{ep}", "captions.txt"))


def test_init_draws_from_the_jax_initializers(jax_run):
    """Each leaf of ``init_state_dicts`` against the same leaf of the JAX
    init: constants (ones, zeros) equal; otherwise the mean within 6
    standard errors of the JAX leaf's mean and the standard deviation
    within 6 standard errors of its standard deviation."""
    cfg = get_config("v2", **TRAIN)
    g_params, g_stats, d_params, d_spectral = jax_run["init"]
    ref = {**state_dict_from_jax(g_params, g_stats, cfg),
           **discriminator_state_dict_from_jax(d_params, d_spectral)}
    g, d = init_state_dicts(cfg, seed=3)
    got = {**g, **d}
    assert set(got) == set(ref)
    for key, r in ref.items():
        x, r = got[key].double().flatten(), r.double().flatten()
        assert x.shape == r.shape, key
        if torch.all(r == r[0]):
            assert torch.equal(x, r), key
            continue
        n, sd = r.numel(), float(r.std())
        assert abs(float(x.mean() - r.mean())) <= 6 * sd * np.sqrt(2 / n), key
        assert abs(float(x.std()) - sd) <= 6 * sd / np.sqrt(n), key
        if "weight_u" in key:
            assert float(x.norm()) == pytest.approx(1.0, rel=1e-6)
    # Another seed, other values.
    assert not torch.equal(init_state_dicts(cfg, seed=4)[0][
        "style_vae_encoder_module.e_conv1.0.weight"],
        g["style_vae_encoder_module.e_conv1.0.weight"])


# -------------------------------------------------------------------- (a)
@pytest.mark.parametrize("patience,factor,threshold",
                         [(0, 0.5, 1e-4), (2, 0.95, 1e-4), (1, 0.1, 0.05)])
def test_plateau_step_matches_jax(patience, factor, threshold):
    kw = dict(patience=patience, factor=factor, threshold=threshold,
              min_lr=1e-6)
    port_cfg = schedule.SchedulerConfig(**kw)
    jax_cfg = jax_schedule.SchedulerConfig(**kw)
    rng = np.random.default_rng(patience)
    metrics = 1.0 + np.cumsum(rng.normal(-0.01, 0.02, 60))
    ps, js = schedule.PlateauState(), jax_schedule.PlateauState()
    lr_p = lr_j = 1e-3
    for m in metrics:
        lr_p = schedule.plateau_step(port_cfg, ps, float(m), lr_p)
        lr_j = jax_schedule.plateau_step(jax_cfg, js, float(m), lr_j)
        assert lr_p == lr_j
        assert (ps.best, ps.num_bad_epochs) == (js.best, js.num_bad_epochs)
    assert lr_p < 1e-3           # the schedule acted


@pytest.mark.parametrize("variant", ["v2", "oldv", "unet"])
def test_kl_weight_matches_jax(variant):
    cfg, jcfg = get_config(variant), jax_get_config(variant)
    for epoch in range(30):
        assert (schedule.kl_weight_for_epoch(cfg, epoch)
                == jax_schedule.kl_weight_for_epoch(jcfg, epoch))


# -------------------------------------------------------------------- (b)
@pytest.mark.parametrize("options", [
    {}, {"text_vocab": 5}, {"text_tile": True}, {"structured": True},
    {"text_dependent": False}],
    ids=["plain", "text_vocab", "text_tile", "structured", "no_text"])
def test_synthetic_dataset_is_the_jax_one(options):
    cfg, jcfg = get_config("v2", **TINY), jax_get_config("v2", **TINY)
    got = SyntheticPatchDataset(cfg, 10, seed=5, **options)
    ref = JaxSyntheticPatchDataset(jcfg, 10, seed=5, **options)
    for name in ("ru", "en", "mask"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.texts == ref.texts
    for step in (0, 3):
        gb, rb = got.batch(4, step), ref.batch(4, step)
        assert set(gb) == set(rb)
        for key in gb:
            assert np.array_equal(np.asarray(gb[key]), np.asarray(rb[key])), key


# -------------------------------------------------------------------- (c)
def test_device_resident_gives_the_host_batches():
    cfg = get_config("v2", **TINY)
    ds = SyntheticPatchDataset(cfg, 10, seed=0)
    train = DeviceResidentSynthetic(ds, 4, 3, device="cpu")
    val = DeviceResidentSynthetic(ds, 4, 2, advance_per_epoch=False,
                                  device="cpu")
    assert train.nbytes() == (ds.ru.nbytes + ds.en.nbytes + ds.mask.nbytes
                              + 10 * cfg.max_text_len * 8)
    for epoch in (0, 1, 2):
        for source, steps, base in ((train, 3, 3 * epoch), (val, 2, 0)):
            batches = list(source(epoch))
            assert len(batches) == steps
            for i, got in enumerate(batches):
                ref = ds.batch(4, base + i)
                assert got["raw_text"] == ref["raw_text"]
                assert got["text"].dtype == torch.int64
                for key in ("ru", "en", "mask", "text"):
                    assert np.array_equal(got[key].numpy(), ref[key]), key
                host = batch_to_device(ref, "cpu")
                for key in host:
                    assert torch.equal(got[key], host[key]), key


# -------------------------------------------------------------------- (d)
def stepped_state(cfg, seed):
    g, d = init_state_dicts(cfg, seed)
    state = create_train_state(cfg, g, d, device="cpu")
    from vae_gan_mark_tpu_torch.models import VGG16Features
    vgg = VGG16Features()
    ds = SyntheticPatchDataset(cfg, 4, seed=seed)
    build_train_step(cfg)(state, vgg, batch_to_device(ds.batch(4), "cpu"),
                          torch.Generator().manual_seed(0), 1e-3)
    return state


def test_checkpoint_round_trip(tmp_path):
    cfg = get_config("v2", **TRAIN)
    state = stepped_state(cfg, 0)
    set_lr(state.opt_g, 3.5e-5)
    sched_g = schedule.PlateauState(best=0.25, num_bad_epochs=2)
    sched_d = schedule.PlateauState(best=0.5, num_bad_epochs=1)
    root = str(tmp_path)
    stale = os.path.join(root, "ck.tmp")
    os.makedirs(stale)
    open(os.path.join(stale, "junk"), "w").close()
    save_checkpoint(root, "ck", state, 4, 0.125, sched_g, sched_d,
                    get_lr(state.opt_g), get_lr(state.opt_d))
    assert not os.path.exists(stale)
    assert sorted(os.listdir(os.path.join(root, "ck"))) == [
        "host_meta.json", "state.pt"]

    fresh = stepped_state(cfg, 1)
    meta = restore_checkpoint(root, "ck", fresh)
    assert meta == dict(epoch=4, best_val=0.125, sched_g=sched_g,
                        sched_d=sched_d, lr_g=3.5e-5, lr_d=get_lr(state.opt_d))
    assert fresh.step == state.step == 1
    assert_states_equal(fresh, state)
    for a, b in ((fresh.opt_g, state.opt_g), (fresh.opt_d, state.opt_d)):
        assert get_lr(a) == get_lr(b)
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        assert sa["state"].keys() == sb["state"].keys()
        for pid, entry in sb["state"].items():
            for key, value in entry.items():
                assert torch.equal(sa["state"][pid][key], value), (pid, key)
                assert sa["state"][pid][key].device == value.device

    # An existing checkpoint is replaced as a whole.
    open(os.path.join(root, "ck", "junk"), "w").close()
    save_checkpoint(root, "ck", fresh, 5, 0.1, sched_g, sched_d, 1e-4, 1e-4)
    assert sorted(os.listdir(os.path.join(root, "ck"))) == [
        "host_meta.json", "state.pt"]
    assert restore_checkpoint(root, "ck", fresh)["epoch"] == 5
    assert restore_checkpoint(root, "missing", fresh) is None


# -------------------------------------------------------------------- (e)
def test_resume_is_bitwise(tmp_path):
    """fit(2), then a new Trainer on the same workdir fit(3), against an
    uninterrupted fit(3): parameters, BatchNorm statistics, spectral u,
    both Adams and the epoch-3 record, bit for bit."""
    cfg = get_config("v2", **TRAIN)
    train_data, val_data, _ = sources(SyntheticPatchDataset, cfg)

    def trainer(name):
        return Trainer(cfg, train_data, val_data, str(tmp_path / name),
                       seed=7, device="cpu")

    trainer("a").fit(2)
    resumed = trainer("a")
    assert (resumed.epoch, resumed.state.step) == (2, 2 * STEPS)
    resumed.fit(3)
    whole = trainer("b")
    whole.fit(3)
    assert_states_equal(resumed.state, whole.state)
    for a, b in ((resumed.state.opt_g, whole.state.opt_g),
                 (resumed.state.opt_d, whole.state.opt_d)):
        for pa, pb in zip(a.state.values(), b.state.values()):
            for key in pb:
                assert torch.equal(pa[key], pb[key]), key
    ra, rb = records(str(tmp_path / "a"))[-1], records(str(tmp_path / "b"))[-1]
    assert {k: v for k, v in ra.items() if k not in UNTIMED} == {
        k: v for k, v in rb.items() if k not in UNTIMED}
    assert (resumed.best_val, resumed.sched_g, resumed.sched_d) == (
        whole.best_val, whole.sched_g, whole.sched_d)


# ------------------------------------------------------------------ other
def test_prefetch_contract():
    def items():
        yield {"x": 1}
        yield None
        yield {"x": 2}

    assert list(prefetch_to_device(items(), lambda b: b["x"])) == [1, 2]

    def broken():
        yield {"x": 1}
        raise KeyError("loader failed")

    it = prefetch_to_device(broken(), lambda b: b["x"])
    assert next(it) == 1
    with pytest.raises(KeyError, match="loader failed"):
        next(it)

    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"x": i}
            i += 1

    it = prefetch_to_device(endless(), lambda b: b["x"], size=2)
    assert next(it) == 0
    it.close()                       # the caller leaves: the thread stops
    import time
    time.sleep(0.5)
    n = len(pulled)
    time.sleep(0.5)
    assert len(pulled) == n <= 5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("v2", **TRAIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, lambda e: iter(()), None, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceResidentSynthetic(SyntheticPatchDataset(cfg, 4), 4, 1)
