"""Top-level VAE-GAN generator for the char-conditioned U-Net variants (v2,
and unet without FiLM).

    model(image, mask, tokens, eps) -> (recon, mu, logvar)

keeps the JAX package's layout at its boundary: ``image`` (B, H, W, 3) and
``mask`` (B, H, W, 1) NHWC in [0, 1], ``tokens`` (B, max_len) int,
``recon`` (B, H, W, 3) and ``mu``/``logvar`` (B, 1, 1, z_ch), all float32.
Inside, tensors are NCHW. The reparameterisation samples in eval too, as
the reference does: ``eps`` (same shape as ``mu``) injects the noise,
otherwise it is drawn from ``generator``.

Submodule names follow the reference's state-dict keys
(``style_vae_encoder_module``, ``char_text_encoder_module``,
``image_vae_decoder_module``), so ``utils/port_jax.py`` and the JAX
package's ``port_v2_generator`` convert between the two.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.decoders import UNetStyleDecoder
from vae_gan_mark_tpu_torch.models.encoders import UNetEncoder
from vae_gan_mark_tpu_torch.models.text_encoders import CharTextEncoder
from vae_gan_mark_tpu_torch.ops.precision import precision_scope, torch_dtype
from vae_gan_mark_tpu_torch.ops.sampling import reparameterize

_NOT_PORTED = {
    "plain": "ROADMAP 'Modules to port': remaining variants (vanilla, "
             "lr_sh: PlainEncoder, PlainDecoder, SbertProjector)",
    "film3": "ROADMAP 'Modules to port': remaining variants (oldv: "
             "CharTextEncoderPosEnc, GatedSkip, strip-factored FiLM)",
}


class VAEGANGenerator(nn.Module):
    def __init__(self, cfg: VariantConfig):
        super().__init__()
        if cfg.generator in _NOT_PORTED:
            raise NotImplementedError(
                f"generator {cfg.generator!r} is not ported yet: "
                f"{_NOT_PORTED[cfg.generator]}")
        if cfg.text_encoder != "char":
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
        self.char_text_encoder_module = CharTextEncoder(
            cfg.vocab_size, cfg.text_feature_width, cfg.char_emb_dim,
            cfg.char_rnn_hidden, cfg.char_rnn_layers, cfg.char_rnn_dropout,
            dtype=dt)
        self.image_vae_decoder_module = UNetStyleDecoder(
            cfg.latent_h, cfg.latent_w, cfg.z_ch, text_ch, cfg.enc_chans,
            cfg.bottleneck_ch, cfg.out_ch, use_film=cfg.generator == "film4",
            fast_film=cfg.fast_film, dtype=dt)

    def forward(self, image: torch.Tensor, mask: torch.Tensor,
                tokens: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        with precision_scope(self.dtype):
            x = torch.cat([image, mask], dim=-1).permute(0, 3, 1, 2)
            mu, logvar, skips = self.style_vae_encoder_module(
                x.to(self.dtype))
            mu32, logvar32 = mu.float(), logvar.float()
            if eps is not None:
                eps = eps.permute(0, 3, 1, 2)              # NHWC -> NCHW
            z = reparameterize(mu32, logvar32, eps, generator).to(self.dtype)
            text_map = self.char_text_encoder_module(tokens)
            recon = self.image_vae_decoder_module(z, text_map, skips)
            return (recon.permute(0, 2, 3, 1).float(),
                    mu32.permute(0, 2, 3, 1), logvar32.permute(0, 2, 3, 1))
