"""vanilla and lr_sh in the port (the plain generator and the sbert text
path) against the JAX package, float32 on the CPU at the tiny geometry of
tests/test_train_fast.py, the same seeded weights on both sides.

Tolerances, and why:

* ``PlainEncoder``, ``SbertProjector``, ``PlainDecoder`` alone, outputs
  and the gradients of a fixed projection of them (parameters and input):
  rtol 1e-4, atol 1e-5, as the v2 modules in test_torch_port_models.py
  (float32 on both sides, the sum order of the convolutions only).
* The whole generators with injected ``eps``: rtol 1e-3, atol 2e-4, as the
  v2 generator (some 10 to 20 layers deep).
* The train steps: as test_torch_port_train.py holds v2's (3 steps,
  metrics rtol 1e-3). The plain generator has a bias ahead of every
  BatchNorm (the encoder's convs, the decoder's transposed convs), whose
  gradient is zero in exact arithmetic: both sides hold rounding noise
  there, held below 1e-4 of the largest moment, and the BatchNorm after
  one holds a running mean that carries the bias, which Adam moves by +-lr
  on the noise's sign (atol 1e-4, as oldv's bottleneck in
  test_torch_port_oldv.py).
* The lr_sh ``Trainer`` against the JAX ``Trainer``: the records within
  rtol 3e-3, as v2's in test_torch_port_trainer.py.
* bf16 against JAX bf16: atol 2e-2 on ``recon``, as in
  test_torch_port_bf16.py.
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
from vae_gan_mark_tpu.models.decoders import PlainDecoder as JaxDecoder
from vae_gan_mark_tpu.models.encoders import PlainEncoder as JaxEncoder
from vae_gan_mark_tpu.models.text_encoders import (
    SbertProjector as JaxProjector)
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.serve.engine import InferenceEngine as JaxEngine
from vae_gan_mark_tpu.train.loop import Trainer as JaxTrainer
from vae_gan_mark_tpu.utils.port_torch import port_vanilla_generator
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
from vae_gan_mark_tpu_torch.data.text_embed import hash_embed
from vae_gan_mark_tpu_torch.models import VAEGANGenerator, VGG16Features
from vae_gan_mark_tpu_torch.models.vaegan import plain_decoder_chans
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.train.loop import Trainer
from vae_gan_mark_tpu_torch.train.state import (
    create_train_state, init_state_dicts)
from vae_gan_mark_tpu_torch.train.step import (
    batch_to_device, build_multi_train_step, build_train_step,
    make_generator)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)

from test_torch_parity_variants import _VanillaGen
from torch_port_common import (
    PLAIN_ZERO_GRADIENT, TINY, Pair, assert_train_steps_match, jax_init,
    make_batch, nchw, nhwc, numpy_tree)

MOD_TOL = dict(rtol=1e-4, atol=1e-5)
GEN_TOL = dict(rtol=1e-3, atol=2e-4)
RECORD_TOL = dict(rtol=3e-3, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    return Pair("vanilla", seed=0, **TINY)


def probe(shape, seed):
    """A fixed random projection: d <probe, out> / d(...) are the
    gradients compared."""
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def assert_grads_close(module, ref_grads, key_of, tol=MOD_TOL):
    got = dict(module.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat) == len(got)
    for path, ref in flat:
        key, layout = key_of(tuple(p.key for p in path))
        grad = got[key].grad.numpy()
        ref = layout(np.asarray(ref))
        np.testing.assert_allclose(grad, ref, rtol=tol["rtol"],
                                   atol=max(tol["atol"],
                                            1e-5 * np.abs(ref).max()),
                                   err_msg=key)


def conv_layout(w):
    return np.transpose(w, (3, 2, 0, 1))


def tconv_layout(w):
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


def test_plain_encoder_matches(tiny):
    cfg = tiny.jax_cfg
    image, mask, _, _ = tiny.inputs(2)
    x = np.concatenate([image, mask], -1)
    module = JaxEncoder(chans=cfg.enc_chans, z_ch=cfg.z_ch, train=False)
    variables = tiny.variables("encoder")
    w = probe((2, 1, 1, cfg.z_ch), 7)

    def loss(params, x):
        mu, logvar = module.apply({**variables, "params": params}, x)
        return jnp.sum(w * mu) + jnp.sum(w * logvar ** 2), (mu, logvar)

    (_, (mu, logvar)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    encoder = tiny.port.encoder
    xt = nchw(x).requires_grad_()
    pmu, plogvar, skips = encoder(xt)
    assert skips is None
    np.testing.assert_allclose(nhwc(pmu), mu, **MOD_TOL)
    np.testing.assert_allclose(nhwc(plogvar), logvar, **MOD_TOL)
    wt = nchw(w)
    ((wt * pmu).sum() + (wt * plogvar ** 2).sum()).backward()
    np.testing.assert_allclose(nhwc(xt.grad), g_x, **MOD_TOL)

    def key_of(path):
        if path[0] == "_LatentHeads_0":
            head, leaf = path[1], path[2]
            return (f"{head}.{'weight' if leaf == 'kernel' else 'bias'}",
                    conv_layout if leaf == "kernel" else np.asarray)
        i = int(path[0].split("_")[1])
        if path[1] == "Conv_0":
            return (f"feat.{3 * i}.{'weight' if path[2] == 'kernel' else 'bias'}",
                    conv_layout if path[2] == "kernel" else np.asarray)
        return (f"feat.{3 * i + 1}.{'weight' if path[2] == 'scale' else 'bias'}",
                np.asarray)

    assert_grads_close(encoder, g_params, key_of)


def test_sbert_projector_matches(tiny):
    cfg = tiny.jax_cfg
    _, _, emb, _ = tiny.inputs(3)
    assert emb.dtype == np.float32 and emb.shape == (3, 384)
    module = JaxProjector(out_dim=cfg.text_ch)
    params = tiny.variables("text_encoder")["params"]
    w = probe((3, cfg.text_ch), 8)

    def loss(params, emb):
        out = module.apply({"params": params}, emb)
        return jnp.sum(w * out), out

    (_, ref), (g_params, g_emb) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, emb)
    proj = tiny.port.text_encoder
    et = torch.from_numpy(emb).requires_grad_()
    out = proj(et)
    np.testing.assert_allclose(out.detach().numpy(), ref, **MOD_TOL)
    (torch.from_numpy(w) * out).sum().backward()
    np.testing.assert_allclose(et.grad.numpy(), g_emb, **MOD_TOL)
    np.testing.assert_allclose(proj.fc.weight.grad.numpy(),
                               np.asarray(g_params["Dense_0"]["kernel"]).T,
                               **MOD_TOL)
    np.testing.assert_allclose(proj.fc.bias.grad.numpy(),
                               g_params["Dense_0"]["bias"], **MOD_TOL)


def test_plain_decoder_matches(tiny):
    cfg = tiny.jax_cfg
    rng = np.random.default_rng(3)
    zc = rng.normal(0, 1, (2, 1, 1, cfg.z_ch + cfg.text_ch)).astype(
        np.float32)
    module = JaxDecoder(latent_h=cfg.latent_h, latent_w=cfg.latent_w,
                        chans=plain_decoder_chans(tiny.cfg),
                        out_ch=cfg.out_ch, train=False)
    variables = tiny.variables("decoder")
    w = probe((2, cfg.patch_h, cfg.patch_w, 3), 9)

    def loss(params, zc):
        out = module.apply({**variables, "params": params}, zc)
        return jnp.sum(w * out), out

    (_, ref), (g_params, g_zc) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], zc)
    decoder = tiny.port.decoder
    zt = nchw(zc).requires_grad_()
    out = decoder(zt)
    assert nhwc(out).shape == (2, cfg.patch_h, cfg.patch_w, 3)
    np.testing.assert_allclose(nhwc(out), ref, **MOD_TOL)
    (nchw(w) * out).sum().backward()
    np.testing.assert_allclose(nhwc(zt.grad), g_zc, **MOD_TOL)

    def key_of(path):
        if path[0] == "Conv_0":
            return (f"decode.15.{'weight' if path[1] == 'kernel' else 'bias'}",
                    conv_layout if path[1] == "kernel" else np.asarray)
        i = int(path[0].split("_")[1])
        if path[1] == "TConv_0":
            return (f"decode.{3 * i}.{'weight' if path[3] == 'kernel' else 'bias'}",
                    tconv_layout if path[3] == "kernel" else np.asarray)
        return (f"decode.{3 * i + 1}.{'weight' if path[2] == 'scale' else 'bias'}",
                np.asarray)

    assert_grads_close(decoder, g_params, key_of)


@pytest.mark.parametrize("variant,overrides", [
    ("vanilla", {}), ("lr_sh", {}),
    ("v2", {"text_encoder": "sbert"}),
    ("oldv", {"text_encoder": "sbert", "enc_chans": (8, 16, 24)})],
    ids=["vanilla", "lr_sh", "v2_sbert", "oldv_sbert"])
def test_tiny_generator_matches(variant, overrides):
    """The whole generators with injected eps; v2 and oldv with the sbert
    text path build a U-Net encoder whose skips go unused and a plain
    decoder, as in JAX."""
    pair = Pair(variant, seed=1, **{**TINY, **overrides})
    args = pair.inputs(3, seed=4)
    for got, ref in zip(pair.run_port(*args), pair.run_jax(*args)):
        np.testing.assert_allclose(got, ref, **GEN_TOL)


def test_state_dict_keys_are_the_reference_keys():
    """The port's full-width vanilla generator has the reference's keys and
    shapes (``encoder.feat`` / ``decoder.decode`` nn.Sequential indices,
    ``text_encoder.fc``), those of the reference-shaped torch model of
    tests/test_torch_parity_variants.py."""
    port = VAEGANGenerator(get_config("vanilla")).state_dict()
    ref = {k: v for k, v in _VanillaGen().state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert port.keys() == ref.keys()
    for key, value in ref.items():
        assert port[key].shape == value.shape, key


@pytest.mark.parametrize("variant", ["vanilla", "lr_sh"])
def test_bridge_round_trip_through_port_vanilla_generator(variant):
    pair = Pair(variant, seed=5, **TINY)
    back_params, back_stats = port_vanilla_generator(pair.port.state_dict(),
                                                     pair.jax_cfg)
    flat = jax.tree_util.tree_flatten_with_path
    for ours, theirs in ((pair.params, back_params),
                         (pair.batch_stats, back_stats)):
        a, b = flat(ours)[0], flat(theirs)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_vanilla_train_steps_match_jax():
    state = assert_train_steps_match("vanilla", jax_init("vanilla"),
                                     load_vgg_params(),
                                     zero_gradient=PLAIN_ZERO_GRADIENT)
    assert state.step == 3


def test_bf16_generator_matches_jax_bf16():
    pair = Pair("vanilla", seed=2, **dict(TINY, compute_dtype="bfloat16"))
    args = pair.inputs(3, seed=6)
    (recon, mu, logvar), (ref_recon, ref_mu, ref_logvar) = (
        pair.run_port(*args), pair.run_jax(*args))
    assert recon.dtype == mu.dtype == np.float32
    np.testing.assert_allclose(recon, ref_recon, rtol=0, atol=2e-2)
    np.testing.assert_allclose(mu, ref_mu, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(logvar, ref_logvar, rtol=2e-2, atol=2e-2)


def test_engine_matches_jax_engine(monkeypatch):
    """The same weights and eps (the JAX side's ``reparameterize`` patched
    to the port engine's noise: one chunk, as the patch is traced once);
    texts through ``hash_embed`` on both sides; 5 requests padded to 8."""
    pair = Pair("vanilla", seed=3, **TINY)
    engine = InferenceEngine(pair.cfg, pair.state_dict, batch_size=8,
                             seed=7, device="cpu")
    ref_engine = JaxEngine(pair.jax_cfg, pair.params, pair.batch_stats,
                           batch_size=8)
    rng = np.random.default_rng(11)
    ru = rng.uniform(0, 1, (5, 32, 64, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (5, 32, 64, 1)) > 0.5).astype(np.float32)
    texts = ["SALE", "50% OFF", "", "скидка", "NEW"]
    noise = engine.noise(0).numpy()
    monkeypatch.setattr(jax_vaegan, "reparameterize",
                        lambda rng_, mu, logvar: mu + noise * jnp.exp(
                            0.5 * logvar))
    ref = ref_engine.generate(ru, mask, texts)
    got = engine.generate(ru, mask, texts)
    assert got.shape == ref.shape == (5, 32, 64, 3)
    np.testing.assert_allclose(got, ref, **GEN_TOL)


def test_engine_defaults_to_the_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tiny.cfg, tiny.state_dict)


def test_multi_step_k4_equals_k1_on_the_cpu():
    """vanilla's float ``text`` through the multi step: 4 steps in one call
    equal 4 single steps bit for bit (eager on the CPU)."""
    cfg = get_config("vanilla", **TINY)
    g_sd, d_sd = init_state_dicts(cfg, seed=4)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(
        numpy_tree(load_vgg_params())))
    batches = [batch_to_device(make_batch(cfg, 40 + i), "cpu")
               for i in range(4)]
    assert batches[0]["text"].dtype == torch.float32
    a = create_train_state(cfg, g_sd, d_sd, device="cpu")
    single = build_train_step(cfg)
    sums = None
    for batch in batches:
        a, m = single(a, vgg, batch,
                      make_generator(torch.device("cpu"), 3, a.step), 1e-3)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    b = create_train_state(cfg, g_sd, d_sd, device="cpu")
    b, multi_sums = build_multi_train_step(cfg)(b, vgg, batches, 3, 1e-3)
    assert a.step == b.step == 4
    for k in sums:
        assert torch.equal(sums[k], multi_sums[k]), k
    for name in ("generator", "discriminator"):
        sa, sb = (getattr(s, name).state_dict() for s in (a, b))
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


# ----------------------------------------------- lr_sh through the Trainer
TRAINER = dict(TINY, char_rnn_dropout=0.0, batch_size=4,
               **{"scheduler.patience": 0, "scheduler.threshold": 0.5})
STEPS, EPOCHS = 3, 3


def with_eps(batch, seed, z_ch):
    """The batch with its own eps, and its texts through ``hash_embed``:
    the synthetic set's embeddings come from Python's salted ``hash``,
    which would give every test process other data."""
    batch = dict(batch)
    batch["eps"] = np.random.default_rng(seed).normal(
        0, 1, (len(batch["ru"]), 1, 1, z_ch)).astype(np.float32)
    batch["text"] = hash_embed(batch["raw_text"])
    return batch


def sources(dataset_cls, cfg):
    """3 train batches an epoch, one val batch."""
    train_ds = dataset_cls(cfg, STEPS * 4, seed=0)
    val_batch = with_eps(dataset_cls(cfg, 4, seed=1).batch(4, 0), 99,
                         cfg.z_ch)

    def train_data(epoch):
        for i in range(STEPS):
            yield with_eps(train_ds.batch(4, i), 10 * epoch + i, cfg.z_ch)

    def val_data(epoch):
        yield val_batch

    return train_data, val_data, val_batch


def records(workdir):
    with open(os.path.join(workdir, "lr_sh.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_lr_sh_trainer_matches_jax_trainer(tmp_path):
    """lr_sh needs no module of its own: its loss weights, lr_d, the
    plateau schedule and the full-loss validation go through the port's
    Trainer as v2's do."""
    jcfg = jax_get_config("lr_sh", **TRAINER)
    cfg = get_config("lr_sh", **TRAINER)
    assert (cfg.full_loss_val, cfg.lr_d, cfg.scheduler is not None) == (
        True, 5e-5, True)
    train_data, val_data, val_batch = sources(JaxSyntheticPatchDataset,
                                              jcfg)

    def fixed_noise(rng, mu, logvar):
        return (mu.astype(jnp.float32) + val_batch["eps"]
                * jnp.exp(0.5 * logvar.astype(jnp.float32))).astype(mu.dtype)

    jax_dir = str(tmp_path / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vaegan, "reparameterize", fixed_noise)
        ref_trainer = JaxTrainer(jcfg, train_data, val_data, jax_dir, seed=0,
                                 use_mesh=False)
        s = ref_trainer.state
        init = (state_dict_from_jax(numpy_tree(s.g_params),
                                    numpy_tree(s.g_batch_stats), cfg),
                discriminator_state_dict_from_jax(numpy_tree(s.d_params),
                                                  numpy_tree(s.d_spectral)))
        ref_trainer.fit(EPOCHS)
    vgg = vgg_state_dict_from_jax(numpy_tree(load_vgg_params()))
    train_data, val_data, _ = sources(SyntheticPatchDataset, cfg)
    port_dir = str(tmp_path / "port")
    trainer = Trainer(cfg, train_data, val_data, port_dir, seed=0,
                      device="cpu", init=init, vgg_state_dict=vgg)
    trainer.fit(EPOCHS)
    got, ref = records(port_dir), records(jax_dir)
    assert len(got) == len(ref) == EPOCHS
    exact = ("epoch", "learning_rate/generator",
             "learning_rate/discriminator")
    for epoch, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        assert {"val/generator_loss", "val/gan_loss_g"} <= set(g)
        for key in r:
            if key in ("time", "train/images_per_sec"):
                continue
            if key in exact:
                assert g[key] == r[key], (epoch, key)
            else:
                np.testing.assert_allclose(g[key], r[key], **RECORD_TOL,
                                           err_msg=f"epoch {epoch}: {key}")
    lrs = [(g["learning_rate/generator"], g["learning_rate/discriminator"])
           for g in got]
    assert lrs[0] == lrs[1] and lrs[2][0] < lrs[1][0] and \
        lrs[2][1] < lrs[1][1]
