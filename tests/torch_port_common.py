"""Shared set-up for the ``test_torch_port_*`` files: the same seeded numpy
weights go into the JAX generator (as parameter trees) and into the PyTorch
port (through ``utils/port_jax.py``), and layouts are converted between
NHWC (JAX) and NCHW (the port's modules). The train-step parity helpers at
the end run the JAX train step and the port's side by side (their
tolerances are explained in test_torch_port_train.py)."""

import re

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models import VAEGANGenerator as JaxGenerator
from vae_gan_mark_tpu.train.state import (
    create_train_state as jax_create_train_state)
from vae_gan_mark_tpu.train.step import (
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch.config import get_config as port_get_config
from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.models import VAEGANGenerator as PortGenerator
from vae_gan_mark_tpu_torch.models import VGG16Features
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, random_jax_tree, state_dict_from_jax,
    vgg_state_dict_from_jax)

# The suite runs several pytest workers side by side on one CPU. torch's
# default of one thread per core has their tiny ops wait on each other's
# threads (a tiny Trainer epoch runs faster on 1-2 threads than on 8, even
# alone), so each worker that imports this module keeps two.
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)

# The tiny geometry of tests/test_train_fast.py.
TINY = dict(patch_h=32, patch_w=64, compute_dtype="float32",
            enc_chans=(8, 16, 24, 32), bottleneck_ch=48, z_ch=16,
            char_emb_dim=16, char_rnn_hidden=16, max_text_len=12)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_tree_shapes_of(cfg, batch: int = 2):
    """The JAX generator's (params, batch_stats) leaf shapes, from
    ``jax.eval_shape`` of its init (no weights are computed)."""
    model = JaxGenerator(cfg=cfg, train=False)
    image = jax.ShapeDtypeStruct((batch, cfg.patch_h, cfg.patch_w, 3),
                                 np.float32)
    mask = jax.ShapeDtypeStruct((batch, cfg.patch_h, cfg.patch_w, 1),
                                np.float32)
    tokens = (jax.ShapeDtypeStruct((batch, cfg.sbert_dim), np.float32)
              if cfg.text_encoder == "sbert" else
              jax.ShapeDtypeStruct((batch, cfg.max_text_len), np.int32))
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(
        lambda i, m, t: model.init({"params": key, "sample": key}, i, m, t),
        image, mask, tokens)
    return jax.tree.map(lambda s: tuple(s.shape), dict(variables))


class Pair:
    """The JAX generator and the port's, with the same seeded weights."""

    def __init__(self, variant: str = "v2", seed: int = 0, **overrides):
        self.jax_cfg = jax_get_config(variant, **overrides)
        self.cfg = port_get_config(variant, **overrides)
        self.params, self.batch_stats = random_jax_tree(self.cfg, seed)
        self.state_dict = state_dict_from_jax(self.params, self.batch_stats,
                                              self.cfg)
        self.port = PortGenerator(self.cfg)
        self.port.load_state_dict(self.state_dict)
        self.port.eval()
        self.jax_model = JaxGenerator(cfg=self.jax_cfg, train=False)

    def variables(self, part=None):
        if part is None:
            return {"params": self.params, "batch_stats": self.batch_stats}
        out = {"params": self.params[part]}
        if part in self.batch_stats:
            out["batch_stats"] = self.batch_stats[part]
        return out

    def inputs(self, batch: int, seed: int = 1):
        """(image, mask, text, eps): ``text`` int32 tokens, or float32
        embeddings for the sbert text path."""
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        image = rng.uniform(0, 1, (batch, cfg.patch_h, cfg.patch_w, 3))
        mask = rng.uniform(0, 1, (batch, cfg.patch_h, cfg.patch_w, 1)) > 0.5
        if cfg.text_encoder == "sbert":
            text = rng.normal(0, 1, (batch, cfg.sbert_dim)).astype(np.float32)
        else:
            text = rng.integers(0, cfg.vocab_size, (batch, cfg.max_text_len))
            text[:, -3:] = 0                            # some PAD
            text = text.astype(np.int32)
        eps = rng.normal(0, 1, (batch, 1, 1, cfg.z_ch))
        return (image.astype(np.float32), mask.astype(np.float32), text,
                eps.astype(np.float32))

    def run_jax(self, image, mask, tokens, eps):
        recon, mu, logvar = self.jax_model.apply(
            self.variables(), image, mask, tokens, eps=eps)
        return np.asarray(recon), np.asarray(mu), np.asarray(logvar)

    def run_port(self, image, mask, tokens, eps):
        with torch.no_grad():
            recon, mu, logvar = self.port(
                torch.from_numpy(image), torch.from_numpy(mask),
                as_batch_tensor("text", torch.from_numpy(tokens)),
                eps=torch.from_numpy(eps))
        return recon.numpy(), mu.numpy(), logvar.numpy()


# ------------------------------------------------------ train-step parity
TRAIN = dict(TINY, char_rnn_dropout=0.0)
# The plain generator's biases ahead of a BatchNorm: zero gradient in exact
# arithmetic (see ``assert_moments_close``).
PLAIN_ZERO_GRADIENT = tuple(
    [f"encoder.feat.{i}.bias" for i in (0, 3, 6, 9)]
    + [f"decoder.decode.{i}.bias" for i in (0, 3, 6, 9, 12)])
BATCH, STEPS, KL_WEIGHT = 4, 3, 1e-3
METRIC_TOL = dict(rtol=1e-3, atol=1e-6)
STATE_TOL = dict(rtol=1e-3, atol=3e-5)


def make_batch(cfg, seed, batch: int = BATCH):
    """A numpy train batch with ``eps``; ``text`` int32 tokens, or float32
    embeddings for the sbert text path."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.patch_h, cfg.patch_w)
    out = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
           "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
           "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5
                    ).astype(np.float32)}
    if cfg.text_encoder == "sbert":
        out["text"] = rng.normal(0, 1, (batch, cfg.sbert_dim)).astype(
            np.float32)
    else:
        out["text"] = rng.integers(0, cfg.vocab_size,
                                   (batch, cfg.max_text_len)).astype(np.int32)
    out["eps"] = rng.normal(0, 1, (batch, 1, 1, cfg.z_ch)).astype(np.float32)
    return out


def jax_init(variant, **overrides):
    """The JAX package's own train state for ``variant`` at ``TRAIN``."""
    cfg = jax_get_config(variant, **dict(TRAIN, **overrides))
    sample = {k: v for k, v in make_batch(cfg, 0).items() if k != "eps"}
    return jax.jit(lambda r, b: jax_create_train_state(cfg, r, b))(
        jax.random.PRNGKey(0), sample)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_from_jax(variant, jax_state, jax_vgg, **overrides):
    """(cfg, state, vgg) of the port, with the JAX state's G, D and VGG."""
    cfg = port_get_config(variant, **dict(TRAIN, **overrides))
    state = create_train_state(
        cfg,
        state_dict_from_jax(numpy_tree(jax_state.g_params),
                            numpy_tree(jax_state.g_batch_stats), cfg),
        discriminator_state_dict_from_jax(numpy_tree(jax_state.d_params),
                                          numpy_tree(jax_state.d_spectral),
                                          cfg),
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


def assert_moments_close(got, ref, zero_gradient=()):
    """Per tensor within 2e-4 of its largest moment, at least 1e-5 of the
    network's largest. The ``zero_gradient`` keys (a conv bias ahead of a
    BatchNorm: its gradient is zero in exact arithmetic) hold rounding
    noise on both sides, which must stay below 1e-4 of the network's
    largest moment."""
    ref = {k: v for k, v in ref.items()
           if "running_" not in k and "weight_u" not in k}
    assert set(got) == set(ref)
    top = max(float(v.abs().max()) for v in ref.values())
    floor = 1e-5 * top
    for key in zero_gradient:
        for side in (got[key], ref.pop(key).numpy()):
            assert float(np.abs(side).max()) <= 1e-4 * top, key
    for key in ref:
        r = ref[key].numpy()
        atol = max(2e-4 * float(np.abs(r).max()), floor)
        np.testing.assert_allclose(got[key], r, rtol=0, atol=atol,
                                   err_msg=key)


def assert_buffers_close(module, ref_sd, marker, zero_gradient=()):
    """``STATE_TOL``; the running mean of a BatchNorm right after a
    ``zero_gradient`` bias at atol 1e-4: Adam moves that bias by +-lr
    (1e-4) on the sign of its rounding noise, which differs between the
    sides, and the batch mean carries the bias."""
    loose = {re.sub(r"\.(\d+)\.bias$",
                    lambda m: f".{int(m.group(1)) + 1}.running_mean", k)
             for k in zero_gradient}
    got = {k: v for k, v in module.state_dict().items() if marker in k}
    assert got and set(got) <= set(ref_sd)
    for key, value in got.items():
        tol = dict(STATE_TOL, atol=1e-4) if key in loose else STATE_TOL
        np.testing.assert_allclose(value.numpy(), ref_sd[key].numpy(),
                                   err_msg=key, **tol)


def assert_train_steps_match(variant, jax_state, jax_vgg,
                             steps: int = STEPS, zero_gradient=(),
                             **overrides):
    """``steps`` train steps of the JAX package and of the port from the
    same state on the same batches: the metrics of every step, BatchNorm's
    running statistics and D's ``u`` after every step, and both Adams'
    first moments after the first (G's ``zero_gradient`` keys as noise,
    see ``assert_moments_close``)."""
    jcfg = jax_get_config(variant, **dict(TRAIN, **overrides))
    jax_step = jax.jit(jax_build_train_step(jcfg))
    cfg, state, vgg = port_from_jax(variant, jax_state, jax_vgg, **overrides)
    step = build_train_step(cfg)
    generator = torch.Generator().manual_seed(0)
    for i in range(steps):
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
            numpy_tree(jax_state.d_params), numpy_tree(jax_state.d_spectral),
            cfg)
        assert_buffers_close(state.generator, g_ref, "running_",
                             zero_gradient)
        assert_buffers_close(state.discriminator, d_ref, "weight_u")
        if i == 0:
            assert_moments_close(
                exp_avgs(state.generator, state.opt_g),
                state_dict_from_jax(adam_mu(jax_state.opt_g),
                                    numpy_tree(jax_state.g_batch_stats),
                                    cfg), zero_gradient)
            d_mu = discriminator_state_dict_from_jax(
                adam_mu(jax_state.opt_d), numpy_tree(jax_state.d_spectral),
                cfg)
            assert_moments_close(exp_avgs(state.discriminator, state.opt_d),
                                 d_mu)
            # The G phase's D forward left D's gradients alone: they are
            # still the D phase's, 2 * exp_avg after Adam's first step.
            for p in state.discriminator.parameters():
                assert p.requires_grad
                torch.testing.assert_close(
                    p.grad, 2 * state.opt_d.state[p]["exp_avg"],
                    rtol=1e-6, atol=0)
    return state
