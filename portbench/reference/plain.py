"""Plain reference of the plain generator with the sbert text path: the
primary script's ``vae-gan.py`` generator (the program's ``vanilla`` and
``lr_sh``).

The encoder is a stack of [Conv k3 s2 p1, BatchNorm, ReLU], one a width
of ``enc_chans``, and two heads whose kernel covers the whole latent grid
(``mu``, ``logvar``). The text path projects a sentence embedding with
``Linear(sbert_dim -> text_ch)``; the projection is tiled over z's 1 x 1
grid and concatenated with z. The decoder lifts that to the latent grid
with a ConvTranspose whose kernel is the grid, then doubles it once a
level with [ConvTranspose k4 s2 p1, BatchNorm, ReLU], from the encoder's
top width halved each time, and ends in a Conv k3 p1 to RGB and a
sigmoid. Keys are the program's (``models/vaegan.py:module_names``):
``encoder.feat``, ``encoder.mu_head``, ``encoder.logvar_head``,
``text_encoder.fc``, ``decoder.decode``.

The sentence embedding is the program's offline one, ``hash_embed``: a
normal vector keyed by the text's SHA-256, computed here by its own copy.
Every convolution and product of the generator is in the bfloat16 group.

The interface every reference module gives the harness is listed in
``__init__.py``.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (BatchNorm, Conv, Linear, Setting, latent_hw,
                             seq)
from reference.precision import Precision

TEXT_PREFIXES = ("text_encoder.",)
F32_MODULES = ()


def embed(text: str, dim: int) -> np.ndarray:
    """The text's pseudo-embedding: N(0, 1) draws of a generator seeded by
    the low 8 bytes (little-endian) of its SHA-256, modulo 2**32."""
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    seed = int.from_bytes(digest[:8], "little") % (2 ** 32)
    return np.random.default_rng(seed).normal(0.0, 1.0, dim)


def text_inputs(cfg: dict, strings: Sequence[str], device) -> torch.Tensor:
    """The (N, sbert_dim) float32 embeddings of ``strings`` on ``device``."""
    dim = cfg["sbert_dim"]
    out = np.zeros((len(strings), dim), np.float32)
    for row, text in enumerate(strings):
        out[row] = embed(text, dim)
    return torch.from_numpy(out).to(device)


def example_text(cfg: dict, rows: int) -> torch.Tensor:
    """Embeddings of the count's batch (made on the current device)."""
    return torch.zeros(rows, cfg["sbert_dim"])


def fix_weights(g_sd: dict) -> None:
    """Every leaf is as drawn."""


def counted(cfg: dict) -> Setting:
    """The plain generator is counted as it computes."""
    return Setting()


def decoder_chans(cfg: dict):
    """The encoder's top width, halved once a level."""
    chans = [cfg["enc_chans"][-1]]
    for _ in cfg["enc_chans"]:
        chans.append(max(chans[-1] // 2, 1))
    return chans


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        layers, prev = [], cfg["in_ch"]
        for i, c in enumerate(cfg["enc_chans"]):
            layers += [(3 * i, Conv(prev, c, 3)), (3 * i + 1, BatchNorm(c))]
            prev = c
        self.feat = seq(*layers)
        self.levels = len(cfg["enc_chans"])
        self.mu_head = Conv(prev, cfg["z_ch"], latent_hw(cfg))
        self.logvar_head = Conv(prev, cfg["z_ch"], latent_hw(cfg))

    def forward(self, x, q):
        m = self.feat._modules
        for i in range(self.levels):
            x = F.relu(m[str(3 * i + 1)](m[str(3 * i)](x, q, stride=2,
                                                      padding=1)))
        return self.mu_head(x, q), self.logvar_head(x, q)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans = decoder_chans(cfg)
        lift = Conv(cfg["z_ch"] + cfg["text_ch"], chans[0], latent_hw(cfg),
                    transpose=True)
        layers = [(0, lift), (1, BatchNorm(chans[0]))]
        for i, (prev, c) in enumerate(zip(chans, chans[1:])):
            n = 3 * (i + 1)
            layers += [(n, Conv(prev, c, 4, transpose=True)),
                       (n + 1, BatchNorm(c))]
        self.blocks = len(chans)
        layers.append((3 * self.blocks, Conv(chans[-1], cfg["out_ch"], 3)))
        self.decode = seq(*layers)

    def forward(self, zc, q):
        m = self.decode._modules
        x = F.relu(m["1"](m["0"](zc, q)))
        for i in range(1, self.blocks):
            x = F.relu(m[str(3 * i + 1)](m[str(3 * i)](x, q, stride=2,
                                                      padding=1)))
        return q.out(torch.sigmoid(m[str(3 * self.blocks)](x, q, padding=1)))


class Generator(nn.Module):
    """(ru (B, H, W, 3), mask (B, H, W, 1), embeddings (B, sbert_dim), eps
    (B, z, 1, 1) or None) -> (recon (B, H, W, 3), mu, logvar (B, z, 1,
    1)). Without ``eps`` the noise is drawn from ``generator`` on the
    inputs' device."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["generator"] != "plain" or cfg["text_encoder"] != "sbert":
            raise ValueError("the plain reference covers the plain "
                             "generator with the sbert text path")
        self.prec = Precision("float32")
        self.encoder = Encoder(cfg)
        self.text_encoder = nn.Module()
        self.text_encoder.fc = Linear(cfg["sbert_dim"], cfg["text_ch"])
        self.decoder = Decoder(cfg)

    def forward(self, ru, mask, text, eps=None,
                generator: Optional[torch.Generator] = None):
        q = self.prec.low
        # In NCHW memory: on the CPU a convolution of the channels-last view
        # took the first layer's weight gradient 4.6e-4 off float64.
        x = torch.cat([ru, mask], dim=-1).permute(0, 3, 1, 2).contiguous()
        mu, logvar = self.encoder(x, q)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=torch.float32)
        z = mu + eps * torch.exp(0.5 * logvar)
        emb = self.text_encoder.fc(text, q)
        recon = self.decoder(torch.cat([z, emb[:, :, None, None]], dim=1), q)
        return recon.permute(0, 2, 3, 1), mu, logvar
