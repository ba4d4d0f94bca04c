"""Top-level VAE-GAN generator for the char-conditioned U-Net variants: v2,
unet without FiLM, and oldv (3 levels, gated skips, a height-4 text map from
``CharTextEncoderPosEnc``).

    model(image, mask, tokens, eps) -> (recon, mu, logvar)

keeps the JAX package's layout at its boundary: ``image`` (B, H, W, 3) and
``mask`` (B, H, W, 1) NHWC in [0, 1], ``tokens`` (B, max_len) int,
``recon`` (B, H, W, 3) and ``mu``/``logvar`` (B, 1, 1, z_ch), all float32.
Inside, tensors are NCHW. The reparameterisation samples in eval too, as
the reference does: ``eps`` (same shape as ``mu``) injects the noise,
otherwise it is drawn from ``generator``. In train mode (``model.train()``)
BatchNorm uses batch statistics and advances its running statistics, and
the BiGRU's inter-layer dropout draws from ``generator`` as well.

With ``cfg.remat_encoder`` the encoder's activations are not kept for the
backward: ``torch.utils.checkpoint`` runs the encoder again there, as the
JAX package's ``nn.remat`` does. The recompute leaves BatchNorm's running
statistics alone (``ops/norms.py:running_stats_frozen``), so they move once
per forward with remat as without it.

Submodule names follow the reference's state-dict keys
(``style_vae_encoder_module``, ``char_text_encoder_module``,
``image_vae_decoder_module``), so ``utils/port_jax.py`` and the JAX
package's ``port_v2_generator`` convert between the two.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.decoders import UNetStyleDecoder
from vae_gan_mark_tpu_torch.models.encoders import UNetEncoder
from vae_gan_mark_tpu_torch.models.text_encoders import (
    CharTextEncoder, CharTextEncoderPosEnc)
from vae_gan_mark_tpu_torch.ops.norms import running_stats_frozen
from vae_gan_mark_tpu_torch.ops.precision import precision_scope, torch_dtype
from vae_gan_mark_tpu_torch.ops.sampling import reparameterize

_NOT_PORTED = {
    "plain": "ROADMAP 'Modules to port': remaining variants (vanilla, "
             "lr_sh: PlainEncoder, PlainDecoder, SbertProjector)",
}


def _recompute_contexts():
    """``checkpoint``'s context_fn: nothing around the first forward; the
    recompute leaves the running statistics alone."""
    return contextlib.nullcontext(), running_stats_frozen()


class VAEGANGenerator(nn.Module):
    def __init__(self, cfg: VariantConfig):
        super().__init__()
        if cfg.generator in _NOT_PORTED:
            raise NotImplementedError(
                f"generator {cfg.generator!r} is not ported yet: "
                f"{_NOT_PORTED[cfg.generator]}")
        if cfg.text_encoder not in ("char", "char_posenc"):
            raise NotImplementedError(
                f"text_encoder {cfg.text_encoder!r} is not ported yet: "
                "ROADMAP 'Modules to port': remaining variants")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        dt = self.dtype
        text_ch = 2 * cfg.char_rnn_hidden
        self.style_vae_encoder_module = UNetEncoder(
            cfg.in_ch, cfg.enc_chans, cfg.bottleneck_ch, cfg.z_ch,
            (cfg.latent_h, cfg.latent_w), dtype=dt)
        text_args = (cfg.vocab_size, cfg.text_feature_width,
                     cfg.char_emb_dim, cfg.char_rnn_hidden,
                     cfg.char_rnn_layers, cfg.char_rnn_dropout)
        if cfg.text_encoder == "char":
            self.char_text_encoder_module = CharTextEncoder(*text_args,
                                                            dtype=dt)
        else:
            self.char_text_encoder_module = CharTextEncoderPosEnc(
                *text_args, out_height=cfg.text_feature_height, dtype=dt)
        self.image_vae_decoder_module = UNetStyleDecoder(
            cfg.latent_h, cfg.latent_w, cfg.z_ch, text_ch, cfg.enc_chans,
            cfg.bottleneck_ch, cfg.out_ch,
            use_film=cfg.generator in ("film4", "film3"),
            gated_skips=cfg.generator == "film3",
            fast_film=cfg.fast_film, dtype=dt)

    def _encode(self, x: torch.Tensor):
        with precision_scope(self.dtype):
            return self.style_vae_encoder_module(x)

    def forward(self, image: torch.Tensor, mask: torch.Tensor,
                tokens: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        with precision_scope(self.dtype):
            x = torch.cat([image, mask], dim=-1).permute(0, 3, 1, 2)
            x = x.to(self.dtype)
            if self.cfg.remat_encoder and torch.is_grad_enabled():
                # The encoder draws no noise, so no RNG state is kept.
                mu, logvar, skips = checkpoint(
                    self._encode, x, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=_recompute_contexts)
            else:
                mu, logvar, skips = self._encode(x)
            mu32, logvar32 = mu.float(), logvar.float()
            if eps is not None:
                eps = eps.permute(0, 3, 1, 2)              # NHWC -> NCHW
            z = reparameterize(mu32, logvar32, eps, generator).to(self.dtype)
            text_map = self.char_text_encoder_module(tokens, generator)
            recon = self.image_vae_decoder_module(z, text_map, skips)
            return (recon.permute(0, 2, 3, 1).float(),
                    mu32.permute(0, 2, 3, 1), logvar32.permute(0, 2, 3, 1))
