"""Plain reference of the char-conditioned U-Net generators: v2
(``film4``: four levels, SpatialFiLM at every stage) and oldv (``film3``:
three levels, gated skips and a height-4 text map with a learnable
positional encoding), each with the char text path (a PAD-masked
embedding into a BiGRU).

It follows vae-gan-v2.py and vae-gan-oldv.py (Andrey1408/vae-gan-mark) in
plain torch operations: SpatialFiLM upsamples the text map to every
stage's full size and predicts gamma and beta there, and the GRU is a loop
over its steps. The keys are the scripts' (and the program's):
``style_vae_encoder_module``, ``char_text_encoder_module``,
``image_vae_decoder_module``.

The interface every reference module gives the harness (``__init__.py``):
``Generator``, ``text_inputs`` (the character alphabet's tokens),
``example_text``, ``fix_weights`` (the PAD row), ``TEXT_PREFIXES``,
``F32_MODULES`` (the BiGRU) and ``counted`` (SpatialFiLM as ``fast_film``
computes it).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (BatchNorm, Conv, Setting, latent_hw, param,
                             seq)
from reference.precision import Precision

TEXT_PREFIXES = ("char_text_encoder_module.",)
F32_MODULES = ("char_text_encoder_module.rnn",)


def tokenize(texts: Sequence[str], alphabet: str, max_len: int) -> np.ndarray:
    """Tokens by the character alphabet: index + 1, 0 for padding and
    unknown characters, cut to ``max_len``."""
    index = {ch: i + 1 for i, ch in enumerate(alphabet)}
    out = np.zeros((len(texts), max_len), np.int64)
    for row, text in enumerate(texts):
        for col, ch in enumerate(text[:max_len]):
            out[row, col] = index.get(ch, 0)
    return out


def text_inputs(cfg: dict, strings: Sequence[str], device) -> torch.Tensor:
    """The (N, max_text_len) int64 tokens of ``strings`` on ``device``."""
    return torch.from_numpy(tokenize(strings, cfg["alphabet"],
                                     cfg["max_text_len"])).to(device)


def example_text(cfg: dict, rows: int) -> torch.Tensor:
    """Tokens of the count's batch (made on the current device)."""
    return torch.zeros(rows, cfg["max_text_len"], dtype=torch.long)


def fix_weights(g_sd: dict) -> None:
    """The padding token's row is zero, as nn.Embedding(padding_idx=0)."""
    g_sd["char_text_encoder_module.embedding.weight"][0].zero_()


def counted(cfg: dict) -> Setting:
    """SpatialFiLM counted as ``fast_film`` computes it, where the
    configuration states it (``_factored_film``)."""
    return Setting(SpatialFiLM, "factored", bool(cfg.get("fast_film")))


class DoubleConv(nn.Module):
    """[Conv3x3 (no bias), BN, ReLU] x 2 at indices 0, 1 / 3, 4."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.add_module("0", Conv(cin, cout, 3, bias=False))
        self.add_module("1", BatchNorm(cout))
        self.add_module("3", Conv(cout, cout, 3, bias=False))
        self.add_module("4", BatchNorm(cout))

    def forward(self, x, q):
        m = self._modules
        x = F.relu(m["1"](m["0"](x, q, padding=1)))
        return F.relu(m["4"](m["3"](x, q, padding=1)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        prev = cfg["in_ch"]
        for i, c in enumerate(cfg["enc_chans"]):
            self.add_module(f"e_conv{i + 1}", DoubleConv(prev, c))
            prev = c
        self.levels = len(cfg["enc_chans"])
        self.bottleneck_conv = DoubleConv(prev, cfg["bottleneck_ch"])
        lat = latent_hw(cfg)
        self.mu_head = Conv(cfg["bottleneck_ch"], cfg["z_ch"], lat)
        self.logvar_head = Conv(cfg["bottleneck_ch"], cfg["z_ch"], lat)

    def forward(self, x, q):
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"e_conv{i + 1}")(x, q)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck_conv(x, q)
        return self.mu_head(x, q), self.logvar_head(x, q), skips


class BiGRU(nn.Module):
    """nn.GRU(bidirectional, batch_first) semantics, gate order r, z, n;
    dropout between layers from a mask the caller draws."""

    def __init__(self, in_dim: int, hidden: int, layers: int):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for layer in range(layers):
            d_in = in_dim if layer == 0 else 2 * hidden
            for sfx in (f"l{layer}", f"l{layer}_reverse"):
                for name, shape in ((f"weight_ih_{sfx}", (3 * hidden, d_in)),
                                    (f"weight_hh_{sfx}", (3 * hidden, hidden)),
                                    (f"bias_ih_{sfx}", (3 * hidden,)),
                                    (f"bias_hh_{sfx}", (3 * hidden,))):
                    self.register_parameter(name, param(shape, "gru",
                                                        hidden))

    def _direction(self, x, sfx: str, reverse: bool, q):
        """x (L, B, E) -> (L, B, H)."""
        w_ih, w_hh = getattr(self, f"weight_ih_{sfx}"), \
            getattr(self, f"weight_hh_{sfx}")
        b_ih, b_hh = getattr(self, f"bias_ih_{sfx}"), \
            getattr(self, f"bias_hh_{sfx}")
        length, batch, _ = x.shape
        gi = q.out(q(x.reshape(length * batch, -1)) @ q(w_ih).t()
                   + b_ih).view(length, batch, -1)
        h = x.new_zeros(batch, self.hidden)
        outs: List[Optional[torch.Tensor]] = [None] * length
        steps = range(length - 1, -1, -1) if reverse else range(length)
        w_hh_q = q(w_hh).t()
        for t in steps:
            gh = q.out(q(h) @ w_hh_q + b_hh)
            i_r, i_z, i_n = gi[t].chunk(3, dim=1)
            h_r, h_z, h_n = gh.chunk(3, dim=1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            outs[t] = h
        return torch.stack(outs)

    def forward(self, x, q, dropout_mask: Optional[Callable] = None):
        """x (B, L, E) -> (B, L, 2H). ``dropout_mask(y)`` gives the keep
        mask, scaled, for the time-major output of every layer but the
        last."""
        y = x.transpose(0, 1)
        for layer in range(self.layers):
            y = torch.cat([self._direction(y, f"l{layer}", False, q),
                           self._direction(y, f"l{layer}_reverse", True, q)],
                          dim=-1)
            if layer + 1 < self.layers and dropout_mask is not None:
                y = y * dropout_mask(y)
        return y.transpose(0, 1)


class TextEncoder(nn.Module):
    """PAD-masked char embedding -> BiGRU -> (oldv: Conv1d k3) -> adaptive
    average pool to W/16 columns -> (oldv: broadcast to height 4 and the
    positional encoding added): (B, 2H, h_t, W/16)."""

    def __init__(self, cfg: dict):
        super().__init__()
        vocab = len(cfg["alphabet"]) + 1
        h = cfg["char_rnn_hidden"]
        self.embedding = nn.Module()
        self.embedding.weight = param((vocab, cfg["char_emb_dim"]),
                                      "normal")
        self.rnn = BiGRU(cfg["char_emb_dim"], h, cfg["char_rnn_layers"])
        self.posenc = cfg["text_encoder"] == "char_posenc"
        self.out_w = cfg["patch_w"] // 16
        self.out_h = cfg["text_feature_height"]
        if self.posenc:
            self.conv1d = Conv(2 * h, 2 * h, 3, dims=1)
            self.pos_enc = param((1, 2 * h, self.out_h, self.out_w),
                                 "normal", value=0.02)

    def forward(self, tokens, prec: Precision, dropout_mask=None):
        emb = F.embedding(tokens, self.embedding.weight) \
            * (tokens != 0)[..., None].float()
        y = self.rnn(emb, prec.f32, dropout_mask)            # (B, L, 2H)
        if self.posenc:
            y = self.conv1d(y.transpose(1, 2), prec.low, padding=1)
            y = F.adaptive_avg_pool1d(y, self.out_w)[:, :, None, :]
            return y.expand(-1, -1, self.out_h, -1) + self.pos_enc
        y = F.adaptive_avg_pool1d(y.transpose(1, 2), self.out_w)
        return y[:, :, None, :]


def bilinear(x, h: int, w: int):
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class SpatialFiLM(nn.Module):
    """gamma * x + beta, both predicted from the text map resized to x's
    size. ``factored`` (set by ``counted`` alone) computes it as the
    program's ``fast_film`` does, for the work count."""

    factored = False

    def __init__(self, c_main: int, c_text: int):
        super().__init__()
        self.c = c_main
        self.param_predictor = seq((0, Conv(c_text, c_text, 3, bias=False)),
                                   (1, BatchNorm(c_text)),
                                   (3, Conv(c_text, 2 * c_main, 1)))

    def forward(self, x, text_map, q):
        if self.factored:
            out = _factored_film(self, x, text_map, q)
            if out is not None:
                return out
        p = self.param_predictor._modules
        t = bilinear(text_map, x.shape[2], x.shape[3])
        t = F.relu(p["1"](p["0"](t, q, padding=1)))
        gb = p["3"](t, q)
        return gb[:, :self.c] * x + gb[:, self.c:]


class GatedSkip(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.alpha = param((1, c, 1, 1), "const", value=0.3)

    def forward(self, skip):
        return skip * torch.sigmoid(self.alpha)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans = list(cfg["enc_chans"])
        text_ch = 2 * cfg["char_rnn_hidden"]
        lat_h, self.lat_w = latent_hw(cfg)
        self.levels = len(chans)
        self.gated = cfg["generator"] == "film3"
        if self.gated:
            self.skip_gates = nn.ModuleList(
                [GatedSkip(c) for c in reversed(chans)])
        self.bottleneck_proc = seq(
            (0, Conv(cfg["z_ch"] + text_ch, cfg["bottleneck_ch"], (lat_h, 1),
                     transpose=True)),
            (1, BatchNorm(cfg["bottleneck_ch"])))
        prev = cfg["bottleneck_ch"]
        for i, c in enumerate(reversed(chans)):
            n = i + 1
            self.add_module(f"up_tconv{n}", Conv(prev, c, 2, transpose=True))
            self.add_module(f"spatial_film{n}", SpatialFiLM(2 * c, text_ch))
            self.add_module(f"conv_block{n}", DoubleConv(2 * c, c))
            prev = c
        self.final_image_conv = Conv(prev, cfg["out_ch"], 1)

    def forward(self, z, text_map, skips, q):
        b = z.shape[0]
        x = torch.cat([z.expand(b, z.shape[1], 1, self.lat_w),
                       bilinear(text_map, 1, self.lat_w)], dim=1)
        bp = self.bottleneck_proc._modules
        x = F.relu(bp["1"](bp["0"](x, q)))
        for i in range(self.levels):
            n = i + 1
            skip = skips[self.levels - 1 - i]
            x = getattr(self, f"up_tconv{n}")(x, q, stride=2)
            if self.gated:
                skip = self.skip_gates[i](skip)
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"spatial_film{n}")(x, text_map, q)
            x = getattr(self, f"conv_block{n}")(x, q)
        return q.out(torch.sigmoid(self.final_image_conv(x, q)))


class Generator(nn.Module):
    """(ru (B, H, W, 3), mask (B, H, W, 1), tokens (B, L), eps (B, z, 1, 1)
    or None) -> (recon (B, H, W, 3), mu, logvar (B, z, 1, 1)). Without
    ``eps`` the noise and then the dropout mask are drawn from
    ``generator``, in that order, on the inputs' device."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["generator"] not in ("film4", "film3") or \
                cfg["text_encoder"] not in ("char", "char_posenc"):
            raise ValueError("the reference covers the film4 / film3 "
                             "generators with a char text path")
        self.cfg = cfg
        self.prec = Precision("float32")
        self.style_vae_encoder_module = Encoder(cfg)
        self.char_text_encoder_module = TextEncoder(cfg)
        self.image_vae_decoder_module = Decoder(cfg)

    def forward(self, ru, mask, tokens, eps=None,
                generator: Optional[torch.Generator] = None):
        q = self.prec.low
        x = torch.cat([ru, mask], dim=-1).permute(0, 3, 1, 2)
        mu, logvar, skips = self.style_vae_encoder_module(x, q)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=torch.float32)
        z = mu + eps * torch.exp(0.5 * logvar)
        rate = self.cfg["char_rnn_dropout"]
        drop = None
        if self.training and rate > 0:
            def drop(y):
                keep = 1.0 - rate
                if y.device.type == "meta":
                    return torch.ones_like(y)
                return torch.empty(y.shape, dtype=torch.float32,
                                   device=y.device).bernoulli_(
                    keep, generator=generator) / keep
        text_map = self.char_text_encoder_module(tokens, self.prec, drop)
        recon = self.image_vae_decoder_module(z, text_map, skips, q)
        return recon.permute(0, 2, 3, 1), mu, logvar


def _factored_film(film: SpatialFiLM, x, text_map, q):
    """SpatialFiLM as ``fast_film`` computes it, exactly and with far fewer
    operations, for the count alone; None where it computes in full. For a
    height-1 text map, three 3-tap convolutions along x of the map resized
    to the stage's width give the three row types (top, interior, bottom)
    of the 3x3 convolution of the upsampled map, and the 1x1 convolution
    runs on those three rows; for a text map of 1 < h_t < H rows, three
    3-tap convolutions of the h_t rows are mixed to H rows by one
    (H, 3 h_t) product, and the 1x1 convolution runs at full size."""
    p = film.param_predictor._modules
    h, w = x.shape[2], x.shape[3]
    h_t = text_map.shape[2]
    k = p["0"].weight                                   # (Ct, Ct, 3, 3)
    if h_t == 1 and h >= 3:
        t = bilinear(text_map, 1, w)
        rows = torch.cat([F.conv2d(t, k[:, :, i:i + 1], padding=(0, 1))
                          for i in range(3)], dim=2)    # (B, Ct, 3, W)
        gb = p["3"](F.relu(p["1"](rows)), q)
        c = film.c
        g, b = gb[:, :c], gb[:, c:]
        return torch.cat([g[:, :, 0:1] * x[:, :, :1] + b[:, :, 0:1],
                          g[:, :, 1:2] * x[:, :, 1:h - 1] + b[:, :, 1:2],
                          g[:, :, 2:3] * x[:, :, h - 1:] + b[:, :, 2:3]],
                         dim=2)
    if 1 < h_t < h:
        t = bilinear(text_map, h_t, w)
        strips = torch.cat([F.conv2d(t, k[:, :, i:i + 1], padding=(0, 1))
                            for i in range(3)], dim=2)  # (B, Ct, 3 h_t, W)
        mix = torch.zeros(h, 3 * h_t, device=x.device)
        gb = p["3"](F.relu(p["1"](torch.matmul(mix, strips))), q)
        return gb[:, :film.c] * x + gb[:, film.c:]
    return None
