"""bfloat16 in the port against bfloat16 in the JAX package, on the CPU at
the tiny geometry of tests/test_train_fast.py (oldv with three levels),
the same seeded weights on both sides.

``compute_dtype="bfloat16"`` casts convolution inputs and weights to bf16
where the JAX package casts them; statistics, the GRU, the losses and the
outputs stay float32. Both sides round every convolution's output to bf16
(8 bits of mantissa), but their float32 sums before the rounding differ in
order, so a value near a rounding boundary lands one bf16 step (2^-8
relative) apart, and that step propagates through the later layers. The
tolerances are set from readings:

* The generator forward in eval mode with injected ``eps``, v2 and oldv:
  ``recon`` (in (0, 1), itself rounded to bf16 before the float32 cast)
  within atol 2e-2, ``mu`` and ``logvar`` within atol 2e-2 + rtol 2e-2;
  every one read 7.8e-3 = 2^-7 at most (two bf16 steps below 1, one
  between 1 and 2) in v2 and oldv.
* One bf16 v2 train step (BiGRU dropout 0, the same batch and ``eps``):
  the metrics within rtol 1e-2 (read 2.7e-3 at most, kl; the rest 8.6e-4
  or less).

A difference well past two bf16 steps would point to a cast in another
place than the JAX package's; none shows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.train.state import (
    create_train_state as jax_create_train_state)
from vae_gan_mark_tpu.train.step import (
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VGG16Features
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)

from torch_port_common import TINY, Pair

BF16 = dict(TINY, compute_dtype="bfloat16")
SHAPES = {"v2": BF16, "oldv": dict(BF16, enc_chans=(8, 16, 24))}
RECON_ATOL = 2e-2
LATENT_TOL = dict(rtol=2e-2, atol=2e-2)
STEP_RTOL = 1e-2


@pytest.mark.parametrize("variant", ["v2", "oldv"])
def test_bf16_generator_matches_jax_bf16(variant):
    pair = Pair(variant, seed=2, **SHAPES[variant])
    args = pair.inputs(3, seed=6)
    (recon, mu, logvar), (ref_recon, ref_mu, ref_logvar) = (
        pair.run_port(*args), pair.run_jax(*args))
    assert recon.dtype == mu.dtype == np.float32
    np.testing.assert_allclose(recon, ref_recon, rtol=0, atol=RECON_ATOL)
    np.testing.assert_allclose(mu, ref_mu, **LATENT_TOL)
    np.testing.assert_allclose(logvar, ref_logvar, **LATENT_TOL)


def test_bf16_train_step_matches_jax_bf16():
    overrides = dict(BF16, char_rnn_dropout=0.0)
    jcfg = jax_get_config("v2", **overrides)
    rng = np.random.default_rng(30)
    shape = (4, jcfg.patch_h, jcfg.patch_w)
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5
                      ).astype(np.float32),
             "text": rng.integers(0, jcfg.vocab_size,
                                  (4, jcfg.max_text_len)).astype(np.int32),
             "eps": rng.normal(0, 1, (4, 1, 1, jcfg.z_ch)
                               ).astype(np.float32)}
    sample = {k: v for k, v in batch.items() if k != "eps"}
    jax_state = jax.jit(lambda r, b: jax_create_train_state(jcfg, r, b))(
        jax.random.PRNGKey(0), sample)
    jax_vgg = load_vgg_params()
    numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg = get_config("v2", **overrides)
    state = create_train_state(
        cfg, state_dict_from_jax(numpy_tree(jax_state.g_params),
                                 numpy_tree(jax_state.g_batch_stats), cfg),
        discriminator_state_dict_from_jax(numpy_tree(jax_state.d_params),
                                          numpy_tree(jax_state.d_spectral)),
        device="cpu")
    vgg = VGG16Features(torch.bfloat16)
    vgg.load_state_dict(vgg_state_dict_from_jax(numpy_tree(jax_vgg)))
    _, ref = jax.jit(jax_build_train_step(jcfg))(
        jax_state, jax_vgg, batch, jax.random.PRNGKey(1), jnp.float32(1e-3))
    _, got = build_train_step(cfg)(state, vgg, batch_to_device(batch, "cpu"),
                                   torch.Generator().manual_seed(0), 1e-3)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=STEP_RTOL, atol=0, err_msg=key)
