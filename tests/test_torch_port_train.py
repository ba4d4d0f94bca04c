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
from vae_gan_mark_tpu.train.step import (
    build_eval_step as jax_build_eval_step)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_eval_step, create_train_state, get_lr, set_lr)
from vae_gan_mark_tpu_torch.train.state import clip_by_global_norm_

from torch_port_common import (
    KL_WEIGHT, METRIC_TOL, TRAIN, assert_train_steps_match, jax_init,
    make_batch, port_from_jax)


@pytest.fixture(scope="module")
def v2_init():
    return jax_init("v2"), load_vgg_params()


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_d_forward", "two_d_forwards"])
def test_train_step_matches_jax(v2_init, fused):
    jax_state, jax_vgg = v2_init
    assert_train_steps_match("v2", jax_state, jax_vgg,
                             fused_disc_forward=fused)


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
