"""The generator's gradient at full width (v2, 448x64, B=2, float32, one
train step, BiGRU dropout 0) in the port against the JAX package's, on the
CPU, with the same weights (the JAX init through the bridge), batch and
``eps``: per tensor, ||m_port - m_jax|| / ||m_jax|| over G's Adam first
moments (0.5 times the clipped gradient), against the port's own spread
between 1 and 8 CPU threads. Marked ``slow``: the JAX step compiles and
runs at full width on the CPU (a minute or two each), so it is not in the
tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_fullwidth_grad.py -m slow -s

Readings on a Xeon CPU with AMX (PERF.md §7), median / worst
tensor, the bottleneck's zero-gradient bias left out:

* v2's own ``lr_d`` (1e-4): port against JAX 1.39e-2 / 1.78e-2, port 1
  against 8 threads 1.07e-2 / 1.70e-2. The two are of one size: D's first
  Adam update, lr * g / (|g| + eps), turns sum-order differences in D's
  near-zero gradients into steps of +-lr, and G's gradient through the
  updated D moves by ~1%. Held: port against JAX within twice the thread
  spread.
* ``lr_d = 0`` (D unchanged by its update): the thread spread falls to
  2.1e-6 / 5.7e-6 and port against JAX to 2.8e-3 / 6.2e-3, float32 sum
  order through some 60 layers on either side. Held: the thread spread's
  median within 1e-5, port against JAX within 1e-2.
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

from torch_port_common import (
    KL_WEIGHT, TORCH_THREADS, adam_mu, exp_avgs, make_batch, numpy_tree)

pytestmark = pytest.mark.slow

FULL = dict(compute_dtype="float32", char_rnn_dropout=0.0)
ZERO_GRADIENT = "image_vae_decoder_module.bottleneck_proc.0.bias"


def l2_spread(a, b):
    """Per-tensor relative L2 differences, sorted."""
    return sorted(float(np.linalg.norm(a[k] - b[k])
                        / max(np.linalg.norm(b[k]), 1e-30))
                  for k in b if k != ZERO_GRADIENT)


@pytest.mark.parametrize("lr_d", [None, 0.0], ids=["lr_d", "d_frozen"])
def test_full_width_generator_gradient_matches_jax(lr_d):
    overrides = dict(FULL) if lr_d is None else dict(FULL, lr_d=lr_d)
    jcfg = jax_get_config("v2", **overrides)
    cfg = get_config("v2", **overrides)
    batch = make_batch(cfg, 10, batch=2)
    sample = {k: v for k, v in batch.items() if k != "eps"}
    jax_state = jax.jit(lambda r, b: jax_create_train_state(jcfg, r, b))(
        jax.random.PRNGKey(0), sample)
    jax_vgg = load_vgg_params()
    g_sd = state_dict_from_jax(numpy_tree(jax_state.g_params),
                               numpy_tree(jax_state.g_batch_stats), cfg)
    d_sd = discriminator_state_dict_from_jax(numpy_tree(jax_state.d_params),
                                             numpy_tree(jax_state.d_spectral))
    vgg_sd = vgg_state_dict_from_jax(numpy_tree(jax_vgg))
    new_state, ref_metrics = jax.jit(jax_build_train_step(jcfg))(
        jax_state, jax_vgg, batch, jax.random.PRNGKey(1),
        jnp.float32(KL_WEIGHT))
    ref = {k: v.numpy() for k, v in state_dict_from_jax(
        adam_mu(new_state.opt_g), numpy_tree(new_state.g_batch_stats),
        cfg).items() if "running_" not in k}
    del jax_state, new_state

    moments = {}
    try:
        for threads in (1, 8):
            torch.set_num_threads(threads)
            state = create_train_state(cfg, g_sd, d_sd, device="cpu")
            vgg = VGG16Features()
            vgg.load_state_dict(vgg_sd)
            state, metrics = build_train_step(cfg)(
                state, vgg, batch_to_device(batch, "cpu"),
                torch.Generator().manual_seed(0), KL_WEIGHT)
            for key in ref_metrics:
                np.testing.assert_allclose(float(metrics[key]),
                                           float(ref_metrics[key]),
                                           rtol=1e-4, err_msg=key)
            moments[threads] = exp_avgs(state.generator, state.opt_g)
    finally:
        torch.set_num_threads(TORCH_THREADS)
    vs_jax = l2_spread(moments[8], ref)
    threads = l2_spread(moments[1], moments[8])
    print(f"\nG's moments per tensor (L2), port against JAX: median "
          f"{vs_jax[len(vs_jax) // 2]:.3e}, worst {vs_jax[-1]:.3e}; port 1 "
          f"against 8 threads: median {threads[len(threads) // 2]:.3e}, "
          f"worst {threads[-1]:.3e}")
    median = len(vs_jax) // 2
    if lr_d is None:
        assert vs_jax[median] <= 2 * threads[median]
    else:
        assert threads[median] <= 1e-5 and vs_jax[median] <= 1e-2
