"""Weight bridge: the JAX package's parameter trees, as nested dicts of numpy
arrays, -> this package's ``state_dict``s, for the generator
(``params``/``batch_stats``), the discriminator (``params``/``spectral``, the
power-iteration ``u`` of every spectral conv) and the frozen VGG16 head
(``params``).

The port's keys are the reference's (``style_vae_encoder_module.e_conv1.0
.weight``, ``char_text_encoder_module.rnn.weight_hh_l0_reverse``,
``encoder.feat.0.weight``, ``decoder.decode.15.bias``, ``text_encoder.fc
.weight``, ``body.0.weight_orig``, ``net.0.weight`` ...), so the JAX
package's ``utils/port_torch.py`` functions ``port_v2_generator``,
``port_vanilla_generator``, ``port_discriminator`` and ``port_vgg_head``
are this bridge's inverses.
Layout changes:

* Conv kernels HWIO -> OIHW.
* ConvTranspose kernels: flip both spatial axes, then (kh, kw, in, out) ->
  (in, out, kh, kw).
* GRU ``w_ih`` (in, 3H) and ``w_hh`` (H, 3H) transposed to torch's (3H, .);
  Dense kernels (in, out) transposed to ``nn.Linear``'s (out, in).
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
* oldv: the text encoder's Conv1d kernel (k, in, out) -> (out, in, k), its
  ``pos_enc`` (1, h, w, C) -> (1, C, h, w), a gated skip's ``alpha`` (C,)
  -> (1, C, 1, 1).

One table per network (``generator_entries``, ``_disc_entries``,
``_vgg_entries``) lists every leaf with its JAX path, its port key, its
layout change and its JAX shape; the bridge, the seeded random init and
the tensor-parallel partition read it. Covers every
generator: the plain one with the sbert projection (vanilla, lr_sh; the
JAX package's ``port_vanilla_generator`` is its inverse), the
char-conditioned U-Nets (v2 with FiLM, unet without, oldv with gated skips
and the positional text encoder), and their mixes (the encoder follows
``cfg.generator``, the text path and decoder ``cfg.text_encoder``); the
discriminator, with the conditional head's leaves when
``cfg.conditional_disc`` (``disc_cond_args``); and VGG16 ``features[:16]``. The seeded trees
stand in for weights that cannot be reproduced with torch's RNG (the JAX
initialisers, VGG's fixed ``PRNGKey(16)``), so that a run without JAX can
build every network: ``random_*`` are test weights (He kernels, random
BatchNorm statistics), ``init_state_dicts`` and ``init_vgg_state_dict`` a
training init from the JAX initializers' distributions.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.discriminator import COND_CH
from vae_gan_mark_tpu_torch.models.vaegan import (
    module_names, plain_decoder_chans)
from vae_gan_mark_tpu_torch.models.vgg import VGG16_HEAD_CFG

Tree = Dict[str, object]


class Entry(NamedTuple):
    collection: str            # "params", "batch_stats" or "spectral"
    path: Tuple[str, ...]      # JAX tree path inside the collection
    key: str                   # port state-dict key
    kind: str                  # a layout change: see to_port_layout
    shape: Tuple[int, ...]     # JAX-side shape


def _bn(jp, sp, ch, names=("scale", "bias", "mean", "var")):
    scale, bias, mean, var = names
    yield Entry("params", jp + (scale,), f"{sp}.weight", "plain", (ch,))
    yield Entry("params", jp + (bias,), f"{sp}.bias", "plain", (ch,))
    yield Entry("batch_stats", jp + (mean,), f"{sp}.running_mean", "plain",
                (ch,))
    yield Entry("batch_stats", jp + (var,), f"{sp}.running_var", "plain",
                (ch,))


def _double_conv(jp, sp, cin, cout):
    for j, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4))):
        block = jp + (f"ConvBNRelu_{j}",)
        yield Entry("params", block + ("Conv_0", "kernel"),
                    f"{sp}.{conv_idx}.weight", "conv",
                    (3, 3, cin if j == 0 else cout, cout))
        yield from _bn(block + ("BatchNorm_0",), f"{sp}.{bn_idx}", cout)


def _latent_heads(jp, sp, cfg: VariantConfig, in_ch: int):
    for head in ("mu_head", "logvar_head"):
        hp = jp + ("_LatentHeads_0", head)
        yield Entry("params", hp + ("kernel",), f"{sp}.{head}.weight", "conv",
                    (cfg.latent_h, cfg.latent_w, in_ch, cfg.z_ch))
        yield Entry("params", hp + ("bias",), f"{sp}.{head}.bias", "plain",
                    (cfg.z_ch,))


def _tconv_bn(jp, sp, tconv_idx, bn_idx, kernel_hw, cin, cout):
    """A ``TConvBNRelu``: ConvTranspose at ``tconv_idx``, BN at ``bn_idx``
    of the Sequential ``sp``."""
    tp = jp + ("TConv_0", "ConvTranspose_0")
    yield Entry("params", tp + ("kernel",), f"{sp}.{tconv_idx}.weight",
                "tconv", tuple(kernel_hw) + (cin, cout))
    yield Entry("params", tp + ("bias",), f"{sp}.{tconv_idx}.bias", "plain",
                (cout,))
    yield from _bn(jp + ("BatchNorm_0",), f"{sp}.{bn_idx}", cout)


def _plain_encoder(cfg: VariantConfig, sp: str):
    """``PlainEncoder``: [Conv, BN, ReLU] per width at ``feat`` indices
    0, 1 / 3, 4 / ..., then the latent heads."""
    enc, prev = ("encoder",), cfg.in_ch
    for i, c in enumerate(cfg.enc_chans):
        jp = enc + (f"ConvBNRelu_{i}",)
        yield Entry("params", jp + ("Conv_0", "kernel"),
                    f"{sp}.feat.{3 * i}.weight", "conv", (3, 3, prev, c))
        yield Entry("params", jp + ("Conv_0", "bias"),
                    f"{sp}.feat.{3 * i}.bias", "plain", (c,))
        yield from _bn(jp + ("BatchNorm_0",), f"{sp}.feat.{3 * i + 1}", c)
        prev = c
    yield from _latent_heads(enc, sp, cfg, prev)


def _unet_encoder(cfg: VariantConfig, sp: str):
    enc, prev = ("encoder",), cfg.in_ch
    for i, c in enumerate(cfg.enc_chans):
        yield from _double_conv(enc + (f"DoubleConvBlock_{i}",),
                                f"{sp}.e_conv{i + 1}", prev, c)
        prev = c
    yield from _double_conv(enc + (f"DoubleConvBlock_{cfg.num_levels}",),
                            f"{sp}.bottleneck_conv", prev, cfg.bottleneck_ch)
    yield from _latent_heads(enc, sp, cfg, cfg.bottleneck_ch)


def _sbert_text(cfg: VariantConfig, sp: str):
    """``SbertProjector``: one Dense, sbert_dim -> text_ch, at ``fc``."""
    jp = ("text_encoder", "Dense_0")
    yield Entry("params", jp + ("kernel",), f"{sp}.fc.weight", "dense",
                (cfg.sbert_dim, cfg.text_ch))
    yield Entry("params", jp + ("bias",), f"{sp}.fc.bias", "plain",
                (cfg.text_ch,))


def _char_text(cfg: VariantConfig, sp: str):
    txt = ("text_encoder", "_CharEmbedGRU_0")
    text_ch = 2 * cfg.char_rnn_hidden
    yield Entry("params", txt + ("Embed_0", "embedding"),
                f"{sp}.embedding.weight", "plain",
                (cfg.vocab_size, cfg.char_emb_dim))
    hid = cfg.char_rnn_hidden
    for layer in range(cfg.char_rnn_layers):
        in_dim = cfg.char_emb_dim if layer == 0 else 2 * hid
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            jp = txt + ("BiGRU_0", f"l{layer}_{direction}")
            tag = f"l{layer}{suffix}"
            yield Entry("params", jp + ("w_ih",), f"{sp}.rnn.weight_ih_{tag}",
                        "gru", (in_dim, 3 * hid))
            yield Entry("params", jp + ("w_hh",), f"{sp}.rnn.weight_hh_{tag}",
                        "gru", (hid, 3 * hid))
            yield Entry("params", jp + ("b_ih",), f"{sp}.rnn.bias_ih_{tag}",
                        "plain", (3 * hid,))
            yield Entry("params", jp + ("b_hh",), f"{sp}.rnn.bias_hh_{tag}",
                        "plain", (3 * hid,))
    if cfg.text_encoder == "char_posenc":
        jp = ("text_encoder", "Conv_0")
        yield Entry("params", jp + ("kernel",), f"{sp}.conv1d.weight",
                    "conv1d", (3, text_ch, text_ch))
        yield Entry("params", jp + ("bias",), f"{sp}.conv1d.bias", "plain",
                    (text_ch,))
        yield Entry("params", ("text_encoder", "pos_enc"), f"{sp}.pos_enc",
                    "nhwc", (1, cfg.text_feature_height,
                             cfg.text_feature_width, text_ch))


def _plain_decoder(cfg: VariantConfig, sp: str):
    """``PlainDecoder``: [ConvTranspose, BN, ReLU] per width at ``decode``
    indices 0, 1 / 3, 4 / ..., the RGB conv after them."""
    dec = ("decoder",)
    chans = plain_decoder_chans(cfg)
    prev, kernel = cfg.z_ch + cfg.text_ch, (cfg.latent_h, cfg.latent_w)
    for i, c in enumerate(chans):
        yield from _tconv_bn(dec + (f"TConvBNRelu_{i}",), f"{sp}.decode",
                             3 * i, 3 * i + 1, kernel, prev, c)
        prev, kernel = c, (4, 4)
    last = 3 * len(chans)
    yield Entry("params", dec + ("Conv_0", "kernel"),
                f"{sp}.decode.{last}.weight", "conv",
                (3, 3, prev, cfg.out_ch))
    yield Entry("params", dec + ("Conv_0", "bias"),
                f"{sp}.decode.{last}.bias", "plain", (cfg.out_ch,))


def _unet_decoder(cfg: VariantConfig, sp: str):
    dec = ("decoder",)
    text_ch = 2 * cfg.char_rnn_hidden
    yield from _tconv_bn(dec + ("TConvBNRelu_0",), f"{sp}.bottleneck_proc",
                         0, 1, (cfg.latent_h, 1), cfg.z_ch + text_ch,
                         cfg.bottleneck_ch)
    prev = cfg.bottleneck_ch
    for i, c in enumerate(reversed(cfg.enc_chans)):
        n = i + 1
        jp = dec + (f"TConv_{i}", "ConvTranspose_0")
        yield Entry("params", jp + ("kernel",), f"{sp}.up_tconv{n}.weight",
                    "tconv", (2, 2, prev, c))
        yield Entry("params", jp + ("bias",), f"{sp}.up_tconv{n}.bias",
                    "plain", (c,))
        if cfg.generator == "film3":
            yield Entry("params", dec + (f"gate{i}", "alpha"),
                        f"{sp}.skip_gates.{i}.alpha", "gate", (c,))
        if cfg.generator in ("film4", "film3"):
            jp = dec + (f"film{i}",)
            fp = f"{sp}.spatial_film{n}.param_predictor"
            yield Entry("params", jp + ("predict_kernel",), f"{fp}.0.weight",
                        "conv", (3, 3, text_ch, text_ch))
            yield from _bn(jp, f"{fp}.1", text_ch,
                           ("bn_scale", "bn_bias", "bn_mean", "bn_var"))
            yield Entry("params", jp + ("gb_kernel",), f"{fp}.3.weight",
                        "conv", (1, 1, text_ch, 4 * c))
            yield Entry("params", jp + ("gb_bias",), f"{fp}.3.bias", "plain",
                        (4 * c,))
        yield from _double_conv(dec + (f"DoubleConvBlock_{i}",),
                                f"{sp}.conv_block{n}", 2 * c, c)
        prev = c
    yield Entry("params", dec + ("Conv_0", "kernel"),
                f"{sp}.final_image_conv.weight", "conv",
                (1, 1, prev, cfg.out_ch))
    yield Entry("params", dec + ("Conv_0", "bias"),
                f"{sp}.final_image_conv.bias", "plain", (cfg.out_ch,))


def generator_entries(cfg: VariantConfig) -> Iterator[Entry]:
    """The generator's leaves (``parallel/mesh.py:partition_params`` reads
    their JAX shapes): the encoder by ``cfg.generator``, the text
    path and the decoder by ``cfg.text_encoder``, as the JAX package's
    ``VAEGANGenerator`` chooses them."""
    enc, text, dec = module_names(cfg)
    yield from (_plain_encoder if cfg.generator == "plain"
                else _unet_encoder)(cfg, enc)
    if cfg.text_encoder == "sbert":
        yield from _sbert_text(cfg, text)
        yield from _plain_decoder(cfg, dec)
    else:
        yield from _char_text(cfg, text)
        yield from _unet_decoder(cfg, dec)


DISC_CHANS = (3, 64, 128, 256, 512)


def disc_cond_args(cfg: Optional[VariantConfig]) -> Dict[str, int]:
    """``PatchDiscriminator``'s keyword arguments for ``cfg``: the head when
    ``cfg.conditional_disc``, with ``cond_vocab = cfg.vocab_size`` for every
    variant, the sbert ones included (as the JAX package's train state
    sets it), and the ``cond_dense`` branch for the sbert text path, whose
    batches carry float embeddings."""
    if cfg is None or not cfg.conditional_disc:
        return {}
    return dict(cond_vocab=cfg.vocab_size,
                cond_dim=cfg.sbert_dim if cfg.text_encoder == "sbert" else 0)


def _disc_entries(cfg: Optional[VariantConfig] = None) -> Iterator[Entry]:
    """``PatchDiscriminator``: spectral convs at the reference's indices 0,
    2, 5, 8, InstanceNorms at 3, 6, 9, the final conv at 11; then, for a
    conditional ``cfg``, the head's leaves."""
    for i, idx in enumerate((0, 2, 5, 8)):
        cin, cout = DISC_CHANS[i], DISC_CHANS[i + 1]
        jp = (f"SpectralConv_{i}",)
        yield Entry("params", jp + ("kernel",), f"body.{idx}.weight_orig",
                    "conv", (4, 4, cin, cout))
        yield Entry("params", jp + ("bias",), f"body.{idx}.bias", "plain",
                    (cout,))
        yield Entry("spectral", jp + ("u",), f"body.{idx}.weight_u", "plain",
                    (cout,))
    for i, idx in enumerate((3, 6, 9)):
        jp, ch = (f"InstanceNorm_{i}",), DISC_CHANS[i + 2]
        yield Entry("params", jp + ("scale",), f"body.{idx}.weight", "plain",
                    (ch,))
        yield Entry("params", jp + ("bias",), f"body.{idx}.bias", "plain",
                    (ch,))
    yield Entry("params", ("Conv_0", "kernel"), "body.11.weight", "conv",
                (4, 4, DISC_CHANS[-1], 1))
    yield Entry("params", ("Conv_0", "bias"), "body.11.bias", "plain", (1,))
    cond = disc_cond_args(cfg)
    if not cond:
        return
    if cond["cond_dim"]:
        yield Entry("params", ("cond_dense", "kernel"), "cond_dense.weight",
                    "dense", (cond["cond_dim"], COND_CH))
        yield Entry("params", ("cond_dense", "bias"), "cond_dense.bias",
                    "plain", (COND_CH,))
    else:
        yield Entry("params", ("cond_embed", "embedding"),
                    "cond_embed.weight", "plain",
                    (cond["cond_vocab"], COND_CH))
    yield Entry("params", ("cond_proj", "kernel"), "cond_proj.weight",
                "dense", (COND_CH, DISC_CHANS[-1]))


def _vgg_entries() -> Iterator[Entry]:
    """VGG16 ``features[:16]``: JAX ``conv0`` .. ``conv6`` at the
    Sequential indices 0, 2, 5, 7, 10, 12, 14."""
    idx, conv, prev = 0, 0, 3
    for c in VGG16_HEAD_CFG:
        if c == "M":
            idx += 1
            continue
        jp = (f"conv{conv}",)
        yield Entry("params", jp + ("kernel",), f"net.{idx}.weight", "conv",
                    (3, 3, prev, c))
        yield Entry("params", jp + ("bias",), f"net.{idx}.bias", "plain",
                    (c,))
        idx, conv, prev = idx + 2, conv + 1, c


def _get(tree: Tree, path: Tuple[str, ...]):
    for name in path:
        tree = tree[name]
    return tree


def _set(tree: Tree, path: Tuple[str, ...], value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def to_port_layout(kind: str, value: np.ndarray) -> np.ndarray:
    """One JAX leaf -> the port's layout for ``kind`` (see the module doc)."""
    if kind == "conv":
        return np.transpose(value, (3, 2, 0, 1))
    if kind == "tconv":
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if kind in ("gru", "dense"):           # (in, out) -> (out, in)
        return value.T
    if kind == "conv1d":                    # (k, in, out) -> (out, in, k)
        return np.transpose(value, (2, 1, 0))
    if kind == "nhwc":                      # (1, H, W, C) -> (1, C, H, W)
        return np.transpose(value, (0, 3, 1, 2))
    if kind == "gate":                      # (C,) -> (1, C, 1, 1)
        return value.reshape(1, -1, 1, 1)
    return value


def _random_leaf(rng: np.random.Generator, e: Entry) -> np.ndarray:
    name = e.path[-1]
    if e.kind in ("conv", "tconv", "conv1d", "dense"):
        # He-normal over the fan-in. A transposed conv whose stride equals
        # its kernel, or whose input is 1 x 1, sums over input channels
        # only; a k4 s2 one over 4 taps of each.
        fan_in = (e.shape[2] * (4 if e.shape[:2] == (4, 4) else 1)
                  if e.kind == "tconv" else int(np.prod(e.shape[:-1])))
        value = rng.normal(0.0, np.sqrt(2.0 / fan_in), e.shape)
    elif name == "alpha":                           # gates around 0.3
        value = rng.uniform(0.0, 0.6, e.shape)
    elif name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        bound = 1.0 / np.sqrt(e.shape[-1] // 3)      # torch's GRU init
        value = rng.uniform(-bound, bound, e.shape)
    elif name in ("scale", "bn_scale"):
        value = rng.uniform(0.8, 1.2, e.shape)
    elif name in ("var", "bn_var"):
        value = rng.uniform(0.5, 2.0, e.shape)      # variances stay positive
    elif name == "embedding":
        value = rng.normal(0.0, 1.0, e.shape)
    elif name == "u":                               # a unit vector
        value = rng.normal(0.0, 1.0, e.shape)
        value /= np.linalg.norm(value)
    else:                                           # biases, running means
        value = rng.normal(0.0, 0.1, e.shape)
    return value.astype(np.float32)


# lecun_normal draws a normal truncated to [-2, 2] and rescales it by this
# factor, the standard deviation of that truncated normal.
_TRUNCATED_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    value = rng.standard_normal(shape, dtype=np.float32)
    flat = value.reshape(-1)
    redraw = np.flatnonzero(np.abs(flat) > 2.0)
    while redraw.size:
        flat[redraw] = rng.standard_normal(redraw.size, dtype=np.float32)
        redraw = redraw[np.abs(flat[redraw]) > 2.0]
    return value


def _init_leaf(rng: np.random.Generator, e: Entry) -> np.ndarray:
    """One leaf from the distribution of the JAX module's own initializer:
    kernels ``lecun_normal`` (fan-in = the product of all but the output
    axis of the HWIO shape), the GRU's uniform(-1/sqrt(H), 1/sqrt(H)), flax
    ``nn.Embed``'s normal(0, 1/sqrt(features)), ``u`` a normal vector over
    its norm, oldv's ``pos_enc`` 0.02 * normal(0, 1), and the constants:
    scales and variances one, biases and means zero, gate ``alpha`` 0.3."""
    name = e.path[-1]
    if e.kind in ("conv", "tconv", "conv1d", "dense"):
        fan_in = int(np.prod(e.shape[:-1]))
        value = _truncated_normal(rng, e.shape) * np.float32(
            np.sqrt(1.0 / fan_in) / _TRUNCATED_STD)
    elif name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        bound = 1.0 / np.sqrt(e.shape[-1] // 3)
        value = rng.uniform(-bound, bound, e.shape)
    elif name == "embedding":
        value = rng.standard_normal(e.shape, dtype=np.float32) * np.float32(
            np.sqrt(1.0 / e.shape[-1]))
    elif name == "u":
        value = rng.standard_normal(e.shape)
        value /= np.linalg.norm(value) + 1e-12
    elif name == "pos_enc":
        value = rng.standard_normal(e.shape, dtype=np.float32) * np.float32(
            0.02)
    elif name == "alpha":
        value = np.full(e.shape, 0.3)
    elif name in ("scale", "bn_scale", "var", "bn_var"):
        value = np.ones(e.shape)
    elif name in ("bias", "bn_bias", "gb_bias", "mean", "bn_mean"):
        value = np.zeros(e.shape)
    else:
        raise ValueError(f"no initializer for {'/'.join(e.path)}")
    return value.astype(np.float32, copy=False)


def _random_trees(entries: Iterator[Entry], seed: int,
                  leaf=_random_leaf) -> Dict[str, Tree]:
    rng = np.random.default_rng(seed)
    trees: Dict[str, Tree] = {}
    for e in entries:
        _set(trees.setdefault(e.collection, {}), e.path, leaf(rng, e))
    return trees


def _state_dict(entries: Iterator[Entry],
                trees: Dict[str, Tree]) -> Dict[str, torch.Tensor]:
    sd = {}
    for e in entries:
        value = np.asarray(_get(trees[e.collection], e.path), np.float32)
        if value.shape != e.shape:
            raise ValueError(f"{'/'.join(e.path)}: shape {value.shape}, "
                             f"expected {e.shape}")
        sd[e.key] = torch.from_numpy(np.array(to_port_layout(e.kind, value),
                                              np.float32))
    return sd


def random_jax_tree(cfg: VariantConfig, seed: int) -> Tuple[Tree, Tree]:
    """Seeded random (params, batch_stats) numpy trees in the JAX
    generator's layout: He-normal conv kernels, torch's GRU init, BN
    variances in [0.5, 2]."""
    trees = _random_trees(generator_entries(cfg), seed)
    return trees["params"], trees["batch_stats"]


def random_discriminator_tree(seed: int,
                              cfg: Optional[VariantConfig] = None
                              ) -> Tuple[Tree, Tree]:
    """Seeded random (params, spectral) numpy trees in the JAX
    discriminator's layout (with the head for a conditional ``cfg``); every
    ``u`` a unit vector."""
    trees = _random_trees(_disc_entries(cfg), seed)
    return trees["params"], trees["spectral"]


def random_vgg_tree(seed: int) -> Tree:
    """Seeded random VGG16-head params in the JAX layout (``conv0`` ..
    ``conv6``, He-normal kernels)."""
    return _random_trees(_vgg_entries(), seed)["params"]


def init_state_dicts(cfg: VariantConfig, seed: int
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """A fresh training init: the generator's and the discriminator's
    (with the head when ``cfg.conditional_disc``) ``state_dict``s drawn with numpy from ``seed``, from the
    distributions of the JAX modules' initializers (``_init_leaf``). The
    values differ from a flax init's; the distributions are the same."""
    rng = np.random.default_rng(seed)
    g_entries = list(generator_entries(cfg))
    d_entries = list(_disc_entries(cfg))
    g = _random_trees(g_entries, int(rng.integers(2 ** 63)), _init_leaf)
    d = _random_trees(d_entries, int(rng.integers(2 ** 63)), _init_leaf)
    return _state_dict(g_entries, g), _state_dict(d_entries, d)


def init_vgg_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """VGG16-head ``state_dict`` from the JAX VGG's initializers (flax
    ``nn.Conv``: ``lecun_normal`` kernels, zero biases)."""
    entries = list(_vgg_entries())
    return _state_dict(entries, _random_trees(entries, seed, _init_leaf))


def state_dict_from_jax(params: Tree, batch_stats: Tree,
                        cfg: VariantConfig) -> Dict[str, torch.Tensor]:
    """JAX generator trees (numpy leaves) -> the port's ``state_dict``."""
    return _state_dict(generator_entries(cfg),
                       {"params": params, "batch_stats": batch_stats})


def discriminator_state_dict_from_jax(
        params: Tree, spectral: Tree, cfg: Optional[VariantConfig] = None
) -> Dict[str, torch.Tensor]:
    """JAX discriminator trees -> ``PatchDiscriminator``'s ``state_dict``
    (with the head's leaves for a conditional ``cfg``)."""
    return _state_dict(_disc_entries(cfg), {"params": params,
                                            "spectral": spectral})


def vgg_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX VGG16-head params -> ``VGG16Features``'s ``state_dict``."""
    return _state_dict(_vgg_entries(), {"params": params})
