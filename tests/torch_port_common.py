"""Shared set-up for the ``test_torch_port_*`` files: the same seeded numpy
weights go into the JAX generator (as parameter trees) and into the PyTorch
port (through ``utils/port_jax.py``), and layouts are converted between
NHWC (JAX) and NCHW (the port's modules)."""

import numpy as np
import torch

import jax

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models import VAEGANGenerator as JaxGenerator
from vae_gan_mark_tpu_torch.config import get_config as port_get_config
from vae_gan_mark_tpu_torch.models import VAEGANGenerator as PortGenerator
from vae_gan_mark_tpu_torch.utils.port_jax import (
    random_jax_tree, state_dict_from_jax)

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
    tokens = jax.ShapeDtypeStruct((batch, cfg.max_text_len), np.int32)
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
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        image = rng.uniform(0, 1, (batch, cfg.patch_h, cfg.patch_w, 3))
        mask = rng.uniform(0, 1, (batch, cfg.patch_h, cfg.patch_w, 1)) > 0.5
        tokens = rng.integers(0, cfg.vocab_size, (batch, cfg.max_text_len))
        tokens[:, -3:] = 0                              # some PAD
        eps = rng.normal(0, 1, (batch, 1, 1, cfg.z_ch))
        return (image.astype(np.float32), mask.astype(np.float32),
                tokens.astype(np.int32), eps.astype(np.float32))

    def run_jax(self, image, mask, tokens, eps):
        recon, mu, logvar = self.jax_model.apply(
            self.variables(), image, mask, tokens, eps=eps)
        return np.asarray(recon), np.asarray(mu), np.asarray(logvar)

    def run_port(self, image, mask, tokens, eps):
        with torch.no_grad():
            recon, mu, logvar = self.port(
                torch.from_numpy(image), torch.from_numpy(mask),
                torch.from_numpy(tokens.astype(np.int64)),
                eps=torch.from_numpy(eps))
        return recon.numpy(), mu.numpy(), logvar.numpy()
