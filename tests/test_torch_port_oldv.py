"""The oldv variant in the port against the JAX package, float32 on the CPU,
at the tiny geometry of tests/test_train_fast.py with oldv's three levels
(``enc_chans=(8, 16, 24)``), the same seeded weights on both sides
(``utils/port_jax.py``).

* ``GatedSkip``, the strip-factored ``SpatialFiLM`` (a height-4 text map,
  train and eval mode) and ``CharTextEncoderPosEnc``: rtol 1e-4, atol 1e-5,
  the module tolerance of test_torch_port_models.py (float32 on both sides,
  sum order only). The strip path also against the port's own naive path
  (the 3x3 conv over the upsampled map), at the same tolerance: they are
  one function computed in two orders.
* The whole generator (outputs, and the gradients of a fixed scalar of
  them with respect to every parameter, in eval mode) against the JAX
  generator: rtol 1e-3, atol 2e-4 for the outputs, the generator tolerance
  of test_torch_port_models.py; each gradient tensor within 2e-4 of its
  largest element, at least 1e-6 (read 4.7e-6 of the largest at most;
  outputs 1.7e-6 at most).
* Three train steps against the JAX train step, as
  test_torch_port_train.py does for v2: metrics rtol 1e-3, atol 1e-6;
  BatchNorm running statistics and spectral ``u`` rtol 1e-3, atol 3e-5,
  but the bottleneck BatchNorm's running mean at atol 1e-4: the
  transposed conv's bias ahead of it has a zero gradient in exact
  arithmetic, Adam turns each side's rounding noise there into steps of up
  to lr = 1e-4, and the running mean follows the bias at 0.1 a step
  (2 lr (0.1 + 0.9 * 0.1 ...) = 5.8e-5 by step 3; read 5.9e-5).
* ``init_state_dicts``: each leaf's mean and standard deviation within 6
  standard errors of the JAX init's, constants equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models import VAEGANGenerator as JaxGenerator
from vae_gan_mark_tpu.models.text_encoders import (
    CharTextEncoderPosEnc as JaxPosEncoder)
from vae_gan_mark_tpu.ops.film import (
    GatedSkip as JaxGatedSkip, SpatialFiLM as JaxSpatialFiLM)
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.train.state import (
    create_train_state as jax_create_train_state)
from vae_gan_mark_tpu.train.step import (
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VAEGANGenerator, VGG16Features
from vae_gan_mark_tpu_torch.ops.film import GatedSkip, SpatialFiLM
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, init_state_dicts, random_jax_tree,
    state_dict_from_jax, to_port_layout, vgg_state_dict_from_jax)

from torch_port_common import TINY, Pair, nchw, nhwc

OLDV_TINY = dict(TINY, enc_chans=(8, 16, 24))
MOD_TOL = dict(rtol=1e-4, atol=1e-5)
GEN_TOL = dict(rtol=1e-3, atol=2e-4)
METRIC_TOL = dict(rtol=1e-3, atol=1e-6)
STATE_TOL = dict(rtol=1e-3, atol=3e-5)
ZERO_GRADIENT_BN_MEAN = "image_vae_decoder_module.bottleneck_proc.1.running_mean"


def test_oldv_is_three_levels_with_a_height_4_text_map():
    cfg = get_config("oldv")
    assert (cfg.generator, cfg.text_encoder) == ("film3", "char_posenc")
    assert cfg.enc_chans == (32, 64, 128) and cfg.bottleneck_ch == 256
    assert (cfg.text_feature_height, cfg.text_feature_width) == (4, 28)
    model = VAEGANGenerator(get_config("oldv", **OLDV_TINY))
    keys = model.state_dict().keys()
    assert {"image_vae_decoder_module.skip_gates.0.alpha",
            "char_text_encoder_module.conv1d.weight",
            "char_text_encoder_module.pos_enc"} <= set(keys)


def test_gated_skip_matches_jax():
    rng = np.random.default_rng(0)
    skip = rng.normal(0, 1, (2, 8, 16, 5)).astype(np.float32)
    alpha = rng.normal(0, 1, (5,)).astype(np.float32)
    ref = JaxGatedSkip().apply({"params": {"alpha": alpha}}, skip)
    gate = GatedSkip(5)
    assert torch.equal(gate.alpha, torch.full((1, 5, 1, 1), 0.3))
    with torch.no_grad():
        gate.alpha.copy_(torch.from_numpy(to_port_layout("gate", alpha)))
        got = gate(nchw(skip))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MOD_TOL)


def film_pair(seed, c_main=6, c_t=8):
    """A JAX SpatialFiLM's variables and the port's module with the same
    weights (random BatchNorm statistics)."""
    rng = np.random.default_rng(seed)
    params = {
        "predict_kernel": rng.normal(0, 0.3, (3, 3, c_t, c_t)),
        "bn_scale": rng.uniform(0.8, 1.2, (c_t,)),
        "bn_bias": rng.normal(0, 0.1, (c_t,)),
        "gb_kernel": rng.normal(0, 0.3, (1, 1, c_t, 2 * c_main)),
        "gb_bias": rng.normal(0, 0.1, (2 * c_main,))}
    stats = {"bn_mean": rng.normal(0, 0.1, (c_t,)),
             "bn_var": rng.uniform(0.5, 2.0, (c_t,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    film = SpatialFiLM(c_main, c_t)
    sd = {"param_predictor.0.weight": to_port_layout(
              "conv", params["predict_kernel"]),
          "param_predictor.1.weight": params["bn_scale"],
          "param_predictor.1.bias": params["bn_bias"],
          "param_predictor.1.running_mean": stats["bn_mean"],
          "param_predictor.1.running_var": stats["bn_var"],
          "param_predictor.3.weight": to_port_layout(
              "conv", params["gb_kernel"]),
          "param_predictor.3.bias": params["gb_bias"]}
    film.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    return {"params": params, "batch_stats": stats}, film


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_strip_film_matches_jax_and_the_naive_path(train):
    """A (B, 4, 4, C_t) text map into a 16x16 stage: the strip path (1 <
    h_t < H) against the JAX strip path, and against the port's naive
    path; in train mode the running statistics too."""
    variables, film = film_pair(1)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 16, 16, 6)).astype(np.float32)
    tmap = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    jax_film = JaxSpatialFiLM(num_features_main=6, train=train, fast=True)
    if train:
        ref, updated = jax_film.apply(variables, x, tmap,
                                      mutable=["batch_stats"])
        ref_stats = updated["batch_stats"]
    else:
        ref = jax_film.apply(variables, x, tmap)
    outs = {}
    for fast in (True, False):
        module = film_pair(1)[1]
        module.fast = fast
        module.train(train)
        with torch.no_grad():
            outs[fast] = module(nchw(x), nchw(tmap))
        if train:
            bn = module.param_predictor[1]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(ref_stats["bn_mean"]),
                                       **MOD_TOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(ref_stats["bn_var"]),
                                       **MOD_TOL)
    np.testing.assert_allclose(nhwc(outs[True]), np.asarray(ref), **MOD_TOL)
    np.testing.assert_allclose(nhwc(outs[True]), nhwc(outs[False]),
                               **MOD_TOL)


@pytest.fixture(scope="module")
def tiny():
    return Pair("oldv", seed=0, **OLDV_TINY)


def test_pos_enc_text_encoder_matches_jax(tiny):
    cfg = tiny.jax_cfg
    _, _, tokens, _ = tiny.inputs(3)
    ref = JaxPosEncoder(
        vocab_size=cfg.vocab_size, out_width=cfg.text_feature_width,
        out_height=cfg.text_feature_height, emb_dim=cfg.char_emb_dim,
        rnn_hidden=cfg.char_rnn_hidden, rnn_layers=cfg.char_rnn_layers,
        dropout=cfg.char_rnn_dropout, train=False).apply(
            tiny.variables("text_encoder"), tokens)
    with torch.no_grad():
        got = tiny.port.char_text_encoder_module(
            torch.from_numpy(tokens.astype(np.int64)))
    assert nhwc(got).shape == (3, 4, cfg.text_feature_width,
                               2 * cfg.char_rnn_hidden)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MOD_TOL)


def test_generator_outputs_and_gradients_match_jax(tiny):
    """Eval mode with injected eps: the outputs, and the gradients of
    sum(w * recon) + sum(mu) + 0.5 sum(logvar) with respect to every
    parameter."""
    args = tiny.inputs(2, seed=4)
    for got, ref in zip(tiny.run_port(*args), tiny.run_jax(*args)):
        np.testing.assert_allclose(got, ref, **GEN_TOL)

    weights = np.random.default_rng(5).normal(
        0, 1, args[0].shape).astype(np.float32)

    def scalar(recon, mu, logvar, w=weights):
        return (recon * w).sum() + mu.sum() + 0.5 * logvar.sum()

    def jax_loss(params):
        return scalar(*tiny.jax_model.apply(
            {"params": params, "batch_stats": tiny.batch_stats}, *args[:3],
            eps=args[3]))

    ref_grads = jax.grad(jax_loss)(jax.tree.map(jnp.asarray, tiny.params))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, ref_grads),
                              tiny.batch_stats, tiny.cfg)
    tiny.port.zero_grad(set_to_none=True)
    scalar(*tiny.port(*(torch.from_numpy(a) for a in args[:2]),
                      torch.from_numpy(args[2].astype(np.int64)),
                      eps=torch.from_numpy(args[3])),
           w=torch.from_numpy(weights)).backward()
    for name, p in tiny.port.named_parameters():
        r = ref[name].numpy()
        atol = max(2e-4 * float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=atol,
                                   err_msg=name)


def test_three_train_steps_match_jax():
    train = dict(OLDV_TINY, char_rnn_dropout=0.0)
    jcfg = jax_get_config("oldv", **train)
    rng = np.random.default_rng(0)

    def make_batch(seed):
        r = np.random.default_rng(seed)
        shape = (4, jcfg.patch_h, jcfg.patch_w)
        return {"ru": r.uniform(0, 1, shape + (3,)).astype(np.float32),
                "en": r.uniform(0, 1, shape + (3,)).astype(np.float32),
                "mask": (r.uniform(0, 1, shape + (1,)) > 0.5
                         ).astype(np.float32),
                "text": r.integers(0, jcfg.vocab_size,
                                   (4, jcfg.max_text_len)).astype(np.int32),
                "eps": r.normal(0, 1, (4, 1, 1, jcfg.z_ch)
                                ).astype(np.float32)}

    del rng
    sample = {k: v for k, v in make_batch(0).items() if k != "eps"}
    jax_state = jax.jit(lambda r, b: jax_create_train_state(jcfg, r, b))(
        jax.random.PRNGKey(0), sample)
    jax_vgg = load_vgg_params()
    numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg = get_config("oldv", **train)
    state = create_train_state(
        cfg, state_dict_from_jax(numpy_tree(jax_state.g_params),
                                 numpy_tree(jax_state.g_batch_stats), cfg),
        discriminator_state_dict_from_jax(numpy_tree(jax_state.d_params),
                                          numpy_tree(jax_state.d_spectral)),
        device="cpu")
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(numpy_tree(jax_vgg)))
    jax_step = jax.jit(jax_build_train_step(jcfg))
    step = build_train_step(cfg)
    generator = torch.Generator().manual_seed(0)
    for i in range(3):
        batch = make_batch(10 + i)
        jax_state, ref = jax_step(jax_state, jax_vgg, batch,
                                  jax.random.PRNGKey(1), jnp.float32(1e-3))
        state, got = step(state, vgg, batch_to_device(batch, "cpu"),
                          generator, 1e-3)
        for key in ref:
            np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                       err_msg=f"step {i}: {key}",
                                       **METRIC_TOL)
        g_ref = state_dict_from_jax(numpy_tree(jax_state.g_params),
                                    numpy_tree(jax_state.g_batch_stats), cfg)
        for key, value in state.generator.state_dict().items():
            if "running_" in key:
                tol = (dict(STATE_TOL, atol=1e-4)
                       if key == ZERO_GRADIENT_BN_MEAN else STATE_TOL)
                np.testing.assert_allclose(value.numpy(), g_ref[key].numpy(),
                                           err_msg=key, **tol)
        d_ref = discriminator_state_dict_from_jax(
            numpy_tree(jax_state.d_params), numpy_tree(jax_state.d_spectral))
        for key, value in state.discriminator.state_dict().items():
            if "weight_u" in key:
                np.testing.assert_allclose(value.numpy(), d_ref[key].numpy(),
                                           err_msg=key, **STATE_TOL)


def test_init_draws_from_the_jax_initializers():
    """Each generator leaf of ``init_state_dicts`` for oldv against the
    same leaf of a flax init: constants (ones, zeros, the gates' 0.3)
    equal; otherwise the mean within 6 standard errors of the JAX leaf's
    mean and the standard deviation within 6 standard errors of its
    standard deviation."""
    jcfg = jax_get_config("oldv", **OLDV_TINY)
    cfg = get_config("oldv", **OLDV_TINY)
    shape = (2, cfg.patch_h, cfg.patch_w)
    variables = JaxGenerator(cfg=jcfg, train=False).init(
        {"params": jax.random.PRNGKey(7), "sample": jax.random.PRNGKey(8)},
        jnp.zeros(shape + (3,)), jnp.zeros(shape + (1,)),
        jnp.zeros((2, cfg.max_text_len), jnp.int32))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray,
                                           variables["batch_stats"]), cfg)
    got, _ = init_state_dicts(cfg, seed=3)
    assert set(got) == set(ref)
    assert torch.all(got["image_vae_decoder_module.skip_gates.0.alpha"]
                     == 0.3)
    for key, r in ref.items():
        x, r = got[key].double().flatten(), r.double().flatten()
        assert x.shape == r.shape, key
        if torch.all(r == r[0]):
            assert torch.equal(x, r), key
            continue
        n, sd = r.numel(), float(r.std())
        assert abs(float(x.mean() - r.mean())) <= 6 * sd * np.sqrt(2 / n), key
        assert abs(float(x.std()) - sd) <= 6 * sd / np.sqrt(n), key


def test_random_tree_covers_oldv():
    cfg = get_config("oldv", **OLDV_TINY)
    params, stats = random_jax_tree(cfg, seed=0)
    assert params["decoder"]["gate0"]["alpha"].shape == (24,)
    assert params["text_encoder"]["pos_enc"].shape == (
        1, 4, cfg.text_feature_width, 2 * cfg.char_rnn_hidden)
