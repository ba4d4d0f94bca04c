"""The port's train and eval steps against the JAX package's, float32 on the
CPU, at the tiny geometry of tests/test_train_fast.py with the BiGRU's
dropout at 0.

The JAX ``create_train_state`` makes G, D (with its spectral ``u``) and the
optimizers; G's params and batch statistics and D's params and ``u`` cross
into the port through ``utils/port_jax.py``, VGG's random head
(``load_vgg_params``) too. Then three steps run on both sides with the same
batches, ``eps`` and ``kl_weight``, for both ``fused_disc_forward`` values.

Tolerances, and why:

* Metrics: rtol 1e-3, atol 1e-6. Both sides are float32 and differ in the
  sum order of some 40 convolutions forward and backward: the first two
  steps agree to 1.3e-5 relative. Adam's first update is lr * g / (|g| +
  eps), which for the few gradients near eps (1e-8) in size turns rounding
  differences into parameter differences of up to lr; through the GAN's
  coupled updates the third step's metrics then read up to 1.7e-4 relative
  (gan_g, fused D forward).
* Adam first moments after step 1 (0.5 times the clipped gradient, on
  either side): per tensor, atol 2e-4 times the tensor's largest moment
  (the first encoder conv's gradient comes back through the whole
  generator; read up to 8.6e-5), but at least 1e-5 times the largest
  moment of the network. The floor covers gradients that are zero in exact
  arithmetic (a conv bias followed by BatchNorm or InstanceNorm), where
  both sides hold rounding noise of 1e-8 or less.
* BatchNorm running statistics and spectral ``u`` after every step: rtol
  1e-3, atol 3e-5. Float32 batch statistics and power iterations agree to
  about 1e-6; the parameter differences above move the third step's running
  means by up to 1.1e-5.
* Eval steps (on the initial weights): the metrics at rtol 1e-3, atol
  1e-6, the patches at rtol 1e-3, atol 2e-4 as in test_torch_port_models.py,
  with the JAX step's noise fixed to the batch's ``eps`` (its eval step
  draws its own).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models import vaegan as jax_vaegan
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.train.state import (
    create_train_state as jax_create_train_state)
from vae_gan_mark_tpu.train.step import (
    build_eval_step as jax_build_eval_step,
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VGG16Features
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_eval_step, build_train_step, create_train_state,
    get_lr, set_lr)
from vae_gan_mark_tpu_torch.train.state import clip_by_global_norm_
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)

from torch_port_common import TINY

TRAIN = dict(TINY, char_rnn_dropout=0.0)
BATCH, STEPS, KL_WEIGHT = 4, 3, 1e-3
METRIC_TOL = dict(rtol=1e-3, atol=1e-6)
STATE_TOL = dict(rtol=1e-3, atol=3e-5)


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (BATCH, cfg.patch_h, cfg.patch_w)
    return {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
            "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
            "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5
                     ).astype(np.float32),
            "text": rng.integers(0, cfg.vocab_size,
                                 (BATCH, cfg.max_text_len)).astype(np.int32),
            "eps": rng.normal(0, 1, (BATCH, 1, 1, cfg.z_ch)
                              ).astype(np.float32)}


def jax_init(variant):
    cfg = jax_get_config(variant, **TRAIN)
    sample = {k: v for k, v in make_batch(cfg, 0).items() if k != "eps"}
    return jax.jit(lambda r, b: jax_create_train_state(cfg, r, b))(
        jax.random.PRNGKey(0), sample)


@pytest.fixture(scope="module")
def v2_init():
    return jax_init("v2"), load_vgg_params()


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_from_jax(variant, jax_state, jax_vgg, **overrides):
    cfg = get_config(variant, **TRAIN, **overrides)
    state = create_train_state(
        cfg,
        state_dict_from_jax(numpy_tree(jax_state.g_params),
                            numpy_tree(jax_state.g_batch_stats), cfg),
        discriminator_state_dict_from_jax(numpy_tree(jax_state.d_params),
                                          numpy_tree(jax_state.d_spectral)),
        device="cpu")
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(numpy_tree(jax_vgg)))
    return cfg, state, vgg


def adam_mu(opt_state):
    """The first moments (``mu``) inside an optax chain's state."""
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(opt_state.inner_state)
    (mu,) = found
    return numpy_tree(mu)


def exp_avgs(module, opt):
    return {name: opt.state[p]["exp_avg"].numpy()
            for name, p in module.named_parameters()}


def assert_moments_close(got, ref):
    ref = {k: v for k, v in ref.items()
           if "running_" not in k and "weight_u" not in k}
    assert set(got) == set(ref)
    floor = 1e-5 * max(float(v.abs().max()) for v in ref.values())
    for key in ref:
        r = ref[key].numpy()
        atol = max(2e-4 * float(np.abs(r).max()), floor)
        np.testing.assert_allclose(got[key], r, rtol=0, atol=atol,
                                   err_msg=key)


def assert_buffers_close(module, ref_sd, marker):
    got = {k: v for k, v in module.state_dict().items() if marker in k}
    assert got and set(got) <= set(ref_sd)
    for key, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref_sd[key].numpy(),
                                   err_msg=key, **STATE_TOL)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_d_forward", "two_d_forwards"])
def test_train_step_matches_jax(v2_init, fused):
    jax_state, jax_vgg = v2_init
    jcfg = jax_get_config("v2", fused_disc_forward=fused, **TRAIN)
    jax_step = jax.jit(jax_build_train_step(jcfg))
    cfg, state, vgg = port_from_jax("v2", jax_state, jax_vgg,
                                    fused_disc_forward=fused)
    step = build_train_step(cfg)
    generator = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        batch = make_batch(cfg, 10 + i)
        jax_state, ref = jax_step(jax_state, jax_vgg, batch,
                                  jax.random.PRNGKey(1),
                                  jnp.float32(KL_WEIGHT))
        state, got = step(state, vgg, batch_to_device(batch, "cpu"),
                          generator, KL_WEIGHT)
        assert state.step == i + 1 and set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                       err_msg=f"step {i}: {key}",
                                       **METRIC_TOL)
        g_ref = state_dict_from_jax(numpy_tree(jax_state.g_params),
                                    numpy_tree(jax_state.g_batch_stats), cfg)
        d_ref = discriminator_state_dict_from_jax(
            numpy_tree(jax_state.d_params), numpy_tree(jax_state.d_spectral))
        assert_buffers_close(state.generator, g_ref, "running_")
        assert_buffers_close(state.discriminator, d_ref, "weight_u")
        if i == 0:
            assert_moments_close(
                exp_avgs(state.generator, state.opt_g),
                state_dict_from_jax(adam_mu(jax_state.opt_g),
                                    numpy_tree(jax_state.g_batch_stats),
                                    cfg))
            d_mu = discriminator_state_dict_from_jax(
                adam_mu(jax_state.opt_d), numpy_tree(jax_state.d_spectral))
            assert_moments_close(exp_avgs(state.discriminator, state.opt_d),
                                 d_mu)
            # The G phase's D forward left D's gradients alone: they are
            # still the D phase's, 2 * exp_avg after Adam's first step.
            for p in state.discriminator.parameters():
                assert p.requires_grad
                torch.testing.assert_close(
                    p.grad, 2 * state.opt_d.state[p]["exp_avg"],
                    rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", ["v2", "unet"])
def test_eval_step_matches_jax(v2_init, variant, monkeypatch):
    """v2 reports the full loss set (``full_loss_val``), unet the
    reconstruction metrics only."""
    jax_state = v2_init[0] if variant == "v2" else jax_init(variant)
    jax_vgg = v2_init[1]
    cfg, state, vgg = port_from_jax(variant, jax_state, jax_vgg)
    batch = make_batch(cfg, 20)

    def fixed_noise(rng, mu, logvar):
        return (mu.astype(jnp.float32) + batch["eps"]
                * jnp.exp(0.5 * logvar.astype(jnp.float32))).astype(mu.dtype)

    monkeypatch.setattr(jax_vaegan, "reparameterize", fixed_noise)
    jcfg = jax_get_config(variant, **TRAIN)
    ref, ref_fake = jax.jit(jax_build_eval_step(jcfg))(
        jax_state, jax_vgg, {k: v for k, v in batch.items() if k != "eps"},
        jax.random.PRNGKey(2), jnp.float32(KL_WEIGHT))
    u_before = state.discriminator.body[0].weight_u.clone()
    got, fake = build_eval_step(cfg)(state, vgg, batch_to_device(batch, "cpu"),
                                     torch.Generator().manual_seed(0),
                                     KL_WEIGHT)
    assert set(got) == set(ref)
    expected = {"recon", "kl", "psnr", "masked_l1", "mark_recovery"}
    if cfg.full_loss_val:
        expected |= {"gan_g", "perc", "loss_G", "loss_D"}
    assert set(got) == expected
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   err_msg=key, **METRIC_TOL)
    np.testing.assert_allclose(fake.numpy(), np.asarray(ref_fake),
                               rtol=1e-3, atol=2e-4)
    assert torch.equal(state.discriminator.body[0].weight_u, u_before)


def test_clip_is_optax_rule_and_lr_is_adjustable():
    """Below the limit the gradient is left as it is; above, it is scaled
    by max_norm / ||g|| exactly (not max_norm / (||g|| + 1e-6))."""
    p, q = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(
        torch.zeros(4))
    p.grad, q.grad = torch.tensor([3.0, 0.0, 0.0]), torch.tensor(
        [0.0, 4.0, 0.0, 0.0])
    assert float(clip_by_global_norm_([p, q], 10.0)) == pytest.approx(5.0)
    assert torch.equal(p.grad, torch.tensor([3.0, 0.0, 0.0]))
    clip_by_global_norm_([p, q], 1.0)
    assert torch.allclose(p.grad, torch.tensor([0.6, 0.0, 0.0]), atol=0)
    assert torch.allclose(q.grad, torch.tensor([0.0, 0.8, 0.0, 0.0]), atol=0)
    opt = torch.optim.Adam([p], lr=1e-4)
    set_lr(opt, 3e-5)
    assert get_lr(opt) == pytest.approx(3e-5)


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(get_config("v2", **TRAIN), {}, {})
