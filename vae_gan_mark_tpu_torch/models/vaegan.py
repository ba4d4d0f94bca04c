"""Top-level VAE-GAN generator for every variant: the plain generator with
the sbert text path (vanilla, lr_sh), and the char-conditioned U-Nets: v2,
unet without FiLM, and oldv (3 levels, gated skips, a height-4 text map
from ``CharTextEncoderPosEnc``).

    model(image, mask, text, eps) -> (recon, mu, logvar)

keeps the JAX package's layout at its boundary: ``image`` (B, H, W, 3) and
``mask`` (B, H, W, 1) NHWC in [0, 1], ``text`` (B, max_len) int tokens for
the char paths or (B, sbert_dim) float32 embeddings for the sbert path,
``recon`` (B, H, W, 3) and ``mu``/``logvar`` (B, 1, 1, z_ch), all float32.
Inside, tensors are NCHW. The reparameterisation samples in eval too, as
the reference does: ``eps`` (same shape as ``mu``) injects the noise,
otherwise it is drawn from ``generator``. In train mode (``model.train()``)
BatchNorm uses batch statistics and advances its running statistics, and
the BiGRU's inter-layer dropout draws from ``generator`` as well.

The parts are chosen as the JAX package chooses them: the encoder by
``cfg.generator`` (``PlainEncoder`` for "plain", else ``UNetEncoder``), the
text path and the decoder by ``cfg.text_encoder`` ("sbert":
``SbertProjector``, tiled over z's 1 x 1 grid and concatenated with z, into
``PlainDecoder``; else a char encoder into ``UNetStyleDecoder``). So oldv
with ``text_encoder="sbert"`` builds a U-Net encoder whose skips go unused
and a plain decoder, as in JAX.

With ``cfg.remat_encoder`` the encoder's activations are not kept for the
backward: ``torch.utils.checkpoint`` runs the encoder again there, as the
JAX package's ``nn.remat`` does. The recompute leaves BatchNorm's running
statistics alone (``ops/norms.py:running_stats_frozen``), so they move once
per forward with remat as without it.

Submodule names follow the reference's state-dict keys: ``encoder``,
``text_encoder``, ``decoder`` for the plain/sbert parts (vae-gan.py's
scheme), ``style_vae_encoder_module``, ``char_text_encoder_module``,
``image_vae_decoder_module`` for the U-Net/char parts; so
``utils/port_jax.py`` and the JAX package's ``port_vanilla_generator`` /
``port_v2_generator`` convert between the two.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.decoders import (
    PlainDecoder, UNetStyleDecoder)
from vae_gan_mark_tpu_torch.models.encoders import PlainEncoder, UNetEncoder
from vae_gan_mark_tpu_torch.models.text_encoders import (
    CharTextEncoder, CharTextEncoderPosEnc, SbertProjector)
from vae_gan_mark_tpu_torch.ops.convblocks import nhwc_to_nchw
from vae_gan_mark_tpu_torch.ops.film import spatial_broadcast
from vae_gan_mark_tpu_torch.ops.norms import running_stats_frozen
from vae_gan_mark_tpu_torch.ops.precision import precision_scope, torch_dtype
from vae_gan_mark_tpu_torch.ops.sampling import reparameterize


def module_names(cfg: VariantConfig) -> Tuple[str, str, str]:
    """The (encoder, text encoder, decoder) submodule names of ``cfg``'s
    generator: the reference's key scheme for each part."""
    enc = "encoder" if cfg.generator == "plain" else \
        "style_vae_encoder_module"
    if cfg.text_encoder == "sbert":
        return enc, "text_encoder", "decoder"
    return enc, "char_text_encoder_module", "image_vae_decoder_module"


def plain_decoder_chans(cfg: VariantConfig) -> Tuple[int, ...]:
    """The plain decoder's widths: the encoder's top width, halved once per
    level (1024, 512, 256, 128, 64 for vanilla)."""
    chans = [cfg.enc_chans[-1]]
    for _ in range(cfg.num_levels):
        chans.append(max(chans[-1] // 2, 1))
    return tuple(chans)


def _recompute_contexts():
    """``checkpoint``'s context_fn: nothing around the first forward; the
    recompute leaves the running statistics alone."""
    return contextlib.nullcontext(), running_stats_frozen()


class VAEGANGenerator(nn.Module):
    def __init__(self, cfg: VariantConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = torch_dtype(cfg.compute_dtype)
        self._names = enc_name, text_name, dec_name = module_names(cfg)
        latent_hw = (cfg.latent_h, cfg.latent_w)
        if cfg.generator == "plain":
            encoder = PlainEncoder(cfg.in_ch, cfg.enc_chans, cfg.z_ch,
                                   latent_hw, dtype=dt)
        else:
            encoder = UNetEncoder(cfg.in_ch, cfg.enc_chans, cfg.bottleneck_ch,
                                  cfg.z_ch, latent_hw, dtype=dt)
        self.add_module(enc_name, encoder)
        if cfg.text_encoder == "sbert":
            self.add_module(text_name, SbertProjector(
                cfg.sbert_dim, cfg.text_ch, dtype=dt))
            self.add_module(dec_name, PlainDecoder(
                cfg.z_ch + cfg.text_ch, cfg.latent_h, cfg.latent_w,
                plain_decoder_chans(cfg), cfg.out_ch, dtype=dt))
            return
        text_args = (cfg.vocab_size, cfg.text_feature_width,
                     cfg.char_emb_dim, cfg.char_rnn_hidden,
                     cfg.char_rnn_layers, cfg.char_rnn_dropout)
        if cfg.text_encoder == "char":
            text = CharTextEncoder(*text_args, dtype=dt)
        else:
            text = CharTextEncoderPosEnc(
                *text_args, out_height=cfg.text_feature_height, dtype=dt)
        self.add_module(text_name, text)
        self.add_module(dec_name, UNetStyleDecoder(
            cfg.latent_h, cfg.latent_w, cfg.z_ch, 2 * cfg.char_rnn_hidden,
            cfg.enc_chans, cfg.bottleneck_ch, cfg.out_ch,
            use_film=cfg.generator in ("film4", "film3"),
            gated_skips=cfg.generator == "film3",
            fast_film=cfg.fast_film, dtype=dt))

    def _encode(self, x: torch.Tensor):
        with precision_scope(self.dtype):
            return getattr(self, self._names[0])(x)

    def forward(self, image: torch.Tensor, mask: torch.Tensor,
                text: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        _, text_name, dec_name = self._names
        with precision_scope(self.dtype):
            x = nhwc_to_nchw(torch.cat([image, mask], dim=-1))
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
            decoder = getattr(self, dec_name)
            if self.cfg.text_encoder == "sbert":
                emb = getattr(self, text_name)(text)
                zc = torch.cat([z, spatial_broadcast(emb, z.shape[2],
                                                     z.shape[3])], dim=1)
                recon = decoder(zc)
            else:
                text_map = getattr(self, text_name)(text, generator)
                recon = decoder(z, text_map, skips)
            return (recon.permute(0, 2, 3, 1).float(),
                    mu32.permute(0, 2, 3, 1), logvar32.permute(0, 2, 3, 1))
