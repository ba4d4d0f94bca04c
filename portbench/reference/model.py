"""Plain reference of the VAE-GAN: the char-conditioned U-Net generator
(v2: ``film4``, four levels, SpatialFiLM at every stage; oldv: ``film3``,
three levels, gated skips and a height-4 text map with a learnable
positional encoding), the PatchGAN discriminator under spectral
normalisation, and the VGG16 head of the perceptual loss.

It follows the published scripts (Andrey1408/vae-gan-mark, vae-gan-v2.py
and vae-gan-oldv.py) in plain torch operations: NCHW, float32, no fused or
factored shortcuts (SpatialFiLM upsamples the text map to every stage's
full size and predicts gamma and beta there), the GRU as a loop over its
60 steps. Parameter and buffer names are the scripts' state-dict keys, so
one state dict loads here and into the program under test.

Each convolution and matrix product rounds its operands through
``precision.Precision``: nothing in float32, one precision lower in the
control. Configurations are the JSON dicts of ``portbench/configs``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reference.precision import Precision, Rounding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_HEAD = (64, 64, "M", 128, 128, "M", 256, 256, 256)

# Init kinds read by the weight maker: "fan_in" U(-1/sqrt(fan_in), ...) as
# torch's default for convolutions and linear layers, "gru" U(-1/sqrt(H),
# ...), "normal" N(0, 1), "fan_out_normal" N(0, 2/fan_out) (torchvision's
# VGG), "one", "zero", "const" and "unit_normal" (a normalised N(0, I)).


def _param(shape, init: str, fan: float = 1.0, value: float = 0.0):
    p = nn.Parameter(torch.empty(shape))
    p.init = (init, fan, value)
    return p


def _buffer(module: nn.Module, name: str, shape, init: str, fan=1.0,
            value=0.0) -> None:
    module.register_buffer(name, torch.empty(shape))
    getattr(module, name).init = (init, fan, value)


class Conv(nn.Module):
    """A convolution (``transpose`` for ConvTranspose2d, ``dims`` 1 for
    Conv1d) computed through a precision group's ``Rounding``."""

    def __init__(self, cin: int, cout: int, k, bias: bool = True,
                 transpose: bool = False, dims: int = 2):
        super().__init__()
        k = (k,) * dims if isinstance(k, int) else tuple(k)
        shape = (cin, cout) + k if transpose else (cout, cin) + k
        fan_in = shape[1] * math.prod(k)
        self.weight = _param(shape, "fan_in", fan_in)
        self.bias = _param((cout,), "fan_in", fan_in) if bias else None
        self.transpose = transpose
        self.dims = dims

    def forward(self, x, q: Rounding, stride=1, padding=0):
        w = q(self.weight)
        x = q(x)
        if self.transpose:
            y = F.conv_transpose2d(x, w, self.bias, stride, padding)
        elif self.dims == 1:
            y = F.conv1d(x, w, self.bias, stride, padding)
        else:
            y = F.conv2d(x, w, self.bias, stride, padding)
        return q.out(y)


class BatchNorm(nn.Module):
    """BatchNorm2d: batch statistics (biased variance) in train mode, the
    running ones (moved by 0.1, unbiased variance) in eval mode."""

    momentum = 0.1

    def __init__(self, c: int):
        super().__init__()
        self.weight = _param((c,), "one")
        self.bias = _param((c,), "zero")
        _buffer(self, "running_mean", (c,), "zero")
        _buffer(self, "running_var", (c,), "one")

    def forward(self, x):
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * n / (n - 1))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


def _seq(*mods) -> nn.Module:
    """A container whose children sit at the scripts' Sequential indices:
    ``(index, module)`` pairs."""
    m = nn.Module()
    for i, mod in mods:
        m.add_module(str(i), mod)
    return m


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


def latent_hw(cfg: dict):
    d = 2 ** len(cfg["enc_chans"])
    return cfg["patch_h"] // d, cfg["patch_w"] // d


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
                    self.register_parameter(name, _param(shape, "gru",
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
        self.embedding.weight = _param((vocab, cfg["char_emb_dim"]),
                                       "normal")
        self.rnn = BiGRU(cfg["char_emb_dim"], h, cfg["char_rnn_layers"])
        self.posenc = cfg["text_encoder"] == "char_posenc"
        self.out_w = cfg["patch_w"] // 16
        self.out_h = cfg["text_feature_height"]
        if self.posenc:
            self.conv1d = Conv(2 * h, 2 * h, 3, dims=1)
            self.pos_enc = _param((1, 2 * h, self.out_h, self.out_w),
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
    def __init__(self, c_main: int, c_text: int):
        super().__init__()
        self.c = c_main
        self.param_predictor = _seq((0, Conv(c_text, c_text, 3, bias=False)),
                                    (1, BatchNorm(c_text)),
                                    (3, Conv(c_text, 2 * c_main, 1)))

    def forward(self, x, text_map, q):
        p = self.param_predictor._modules
        t = bilinear(text_map, x.shape[2], x.shape[3])
        t = F.relu(p["1"](p["0"](t, q, padding=1)))
        gb = p["3"](t, q)
        return gb[:, :self.c] * x + gb[:, self.c:]


class GatedSkip(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.alpha = _param((1, c, 1, 1), "const", value=0.3)

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
        self.bottleneck_proc = _seq(
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


class SpectralConv(nn.Module):
    """Conv2d k4 s2 p1 under spectral norm, one power iteration a forward
    (``update``) with ``u`` kept as ``weight_u``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight_orig = _param((cout, cin, 4, 4), "fan_in", cin * 16)
        self.bias = _param((cout,), "fan_in", cin * 16)
        _buffer(self, "weight_u", (cout,), "unit_normal")

    def forward(self, x, q, update: bool):
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        with torch.no_grad():
            v = w.t() @ self.weight_u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            if update:
                u = w @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
                self.weight_u.copy_(u)
            u = self.weight_u.clone()
        sigma = torch.dot(u, w @ v)
        return q.out(F.conv2d(q(x), q(self.weight_orig / sigma), self.bias,
                              2, 1))


class InstanceNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = _param((c,), "one")
        self.bias = _param((c,), "zero")

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True,
                                   unbiased=False)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class Discriminator(nn.Module):
    """(B, H, W, 3) -> (B, 1, H/16 - 1, W/16 - 1) patch logits."""

    def __init__(self):
        super().__init__()
        self.prec = Precision("float32")
        self.body = _seq((0, SpectralConv(3, 64)), (2, SpectralConv(64, 128)),
                         (3, InstanceNorm(128)), (5, SpectralConv(128, 256)),
                         (6, InstanceNorm(256)), (8, SpectralConv(256, 512)),
                         (9, InstanceNorm(512)), (11, Conv(512, 1, 4)))

    def forward(self, x, update: bool = True):
        m, q = self.body._modules, self.prec.f32
        y = x.permute(0, 3, 1, 2)
        y = F.leaky_relu(m["0"](y, q, update), 0.2)
        for conv, norm in (("2", "3"), ("5", "6"), ("8", "9")):
            y = F.leaky_relu(m[norm](m[conv](y, q, update)), 0.2)
        return m["11"](y, q, stride=1, padding=1)


class VGGHead(nn.Module):
    """VGG16 features[:16] (relu3_3) of ImageNet-normalised NHWC images."""

    def __init__(self):
        super().__init__()
        self.prec = Precision("float32")
        net, prev, idx = nn.Module(), 3, 0
        self.plan: List = []
        for c in VGG_HEAD:
            if c == "M":
                self.plan.append("M")
                idx += 1
                continue
            conv = Conv(prev, c, 3)
            conv.weight.init = ("fan_out_normal", c * 9, 0.0)
            conv.bias.init = ("zero", 1.0, 0.0)
            net.add_module(str(idx), conv)
            self.plan.append(str(idx))
            prev, idx = c, idx + 2
        self.net = net
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x):
        y = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        for step in self.plan:
            if step == "M":
                y = F.max_pool2d(y, 2, 2)
            else:
                y = F.relu(self.net._modules[step](y, self.prec.low,
                                                    padding=1))
        return y


def set_precision(modules: Sequence[nn.Module], name: str) -> None:
    for m in modules:
        m.prec = Precision(name)
