"""Weight bridge: the JAX package's parameter trees, as nested dicts of numpy
arrays, -> this package's ``state_dict``s, for the generator
(``params``/``batch_stats``), the discriminator (``params``/``spectral``, the
power-iteration ``u`` of every spectral conv) and the frozen VGG16 head
(``params``).

The port's keys are the reference's (``style_vae_encoder_module.e_conv1.0
.weight``, ``char_text_encoder_module.rnn.weight_hh_l0_reverse``,
``body.0.weight_orig``, ``net.0.weight`` ...), so the JAX package's
``utils/port_torch.py`` functions ``port_v2_generator``,
``port_discriminator`` and ``port_vgg_head`` are this bridge's inverses.
Layout changes:

* Conv kernels HWIO -> OIHW.
* ConvTranspose kernels: flip both spatial axes, then (kh, kw, in, out) ->
  (in, out, kh, kw).
* GRU ``w_ih`` (in, 3H) and ``w_hh`` (H, 3H) transposed to torch's (3H, .).
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

One table per network (``_entries``, ``_disc_entries``, ``_vgg_entries``)
lists every leaf with its JAX path, its port key, its layout change and its
JAX shape; the bridge and the seeded random init both read it. Covers the
char-conditioned U-Net generators (v2 with FiLM, unet without), the
unconditional discriminator and VGG16 ``features[:16]``. The seeded trees
stand in for weights that cannot be reproduced with torch's RNG (the JAX
initialisers, VGG's fixed ``PRNGKey(16)``), so that a run without JAX can
build every network: ``random_*`` are test weights (He kernels, random
BatchNorm statistics), ``init_state_dicts`` and ``init_vgg_state_dict`` a
training init from the JAX initializers' distributions.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.models.vgg import VGG16_HEAD_CFG

Tree = Dict[str, object]


class Entry(NamedTuple):
    collection: str            # "params", "batch_stats" or "spectral"
    path: Tuple[str, ...]      # JAX tree path inside the collection
    key: str                   # port state-dict key
    kind: str                  # "conv", "tconv", "gru" or "plain"
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


def _entries(cfg: VariantConfig) -> Iterator[Entry]:
    if cfg.generator not in ("film4", "unet") or cfg.text_encoder != "char":
        raise NotImplementedError(
            f"the weight bridge covers the v2/unet generators, not "
            f"{cfg.generator!r}/{cfg.text_encoder!r}")
    levels = cfg.num_levels
    text_ch = 2 * cfg.char_rnn_hidden

    enc, sp = ("encoder",), "style_vae_encoder_module"
    prev = cfg.in_ch
    for i, c in enumerate(cfg.enc_chans):
        yield from _double_conv(enc + (f"DoubleConvBlock_{i}",),
                                f"{sp}.e_conv{i + 1}", prev, c)
        prev = c
    yield from _double_conv(enc + (f"DoubleConvBlock_{levels}",),
                            f"{sp}.bottleneck_conv", prev, cfg.bottleneck_ch)
    for head in ("mu_head", "logvar_head"):
        jp = enc + ("_LatentHeads_0", head)
        yield Entry("params", jp + ("kernel",), f"{sp}.{head}.weight", "conv",
                    (cfg.latent_h, cfg.latent_w, cfg.bottleneck_ch, cfg.z_ch))
        yield Entry("params", jp + ("bias",), f"{sp}.{head}.bias", "plain",
                    (cfg.z_ch,))

    txt, sp = ("text_encoder", "_CharEmbedGRU_0"), "char_text_encoder_module"
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

    dec, sp = ("decoder",), "image_vae_decoder_module"
    jp = dec + ("TConvBNRelu_0",)
    yield Entry("params", jp + ("TConv_0", "ConvTranspose_0", "kernel"),
                f"{sp}.bottleneck_proc.0.weight", "tconv",
                (cfg.latent_h, 1, cfg.z_ch + text_ch, cfg.bottleneck_ch))
    yield Entry("params", jp + ("TConv_0", "ConvTranspose_0", "bias"),
                f"{sp}.bottleneck_proc.0.bias", "plain", (cfg.bottleneck_ch,))
    yield from _bn(jp + ("BatchNorm_0",), f"{sp}.bottleneck_proc.1",
                   cfg.bottleneck_ch)
    prev = cfg.bottleneck_ch
    for i, c in enumerate(reversed(cfg.enc_chans)):
        n = i + 1
        jp = dec + (f"TConv_{i}", "ConvTranspose_0")
        yield Entry("params", jp + ("kernel",), f"{sp}.up_tconv{n}.weight",
                    "tconv", (2, 2, prev, c))
        yield Entry("params", jp + ("bias",), f"{sp}.up_tconv{n}.bias",
                    "plain", (c,))
        if cfg.generator == "film4":
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


DISC_CHANS = (3, 64, 128, 256, 512)


def _disc_entries() -> Iterator[Entry]:
    """The unconditional ``PatchDiscriminator``: spectral convs at the
    reference's indices 0, 2, 5, 8, InstanceNorms at 3, 6, 9, the final conv
    at 11."""
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
    if kind == "gru":
        return value.T
    return value


def _random_leaf(rng: np.random.Generator, e: Entry) -> np.ndarray:
    name = e.path[-1]
    if e.kind in ("conv", "tconv"):
        # He-normal over the fan-in. A stride-equal-to-kernel transposed conv
        # sums over input channels only.
        fan_in = e.shape[2] if e.kind == "tconv" else int(np.prod(e.shape[:3]))
        value = rng.normal(0.0, np.sqrt(2.0 / fan_in), e.shape)
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
    its norm, and the constants: scales and variances one, biases and means
    zero."""
    name = e.path[-1]
    if e.kind in ("conv", "tconv"):
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
    trees = _random_trees(_entries(cfg), seed)
    return trees["params"], trees["batch_stats"]


def random_discriminator_tree(seed: int) -> Tuple[Tree, Tree]:
    """Seeded random (params, spectral) numpy trees in the JAX
    discriminator's layout; every ``u`` a unit vector."""
    trees = _random_trees(_disc_entries(), seed)
    return trees["params"], trees["spectral"]


def random_vgg_tree(seed: int) -> Tree:
    """Seeded random VGG16-head params in the JAX layout (``conv0`` ..
    ``conv6``, He-normal kernels)."""
    return _random_trees(_vgg_entries(), seed)["params"]


def init_state_dicts(cfg: VariantConfig, seed: int
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """A fresh training init: the generator's and the unconditional
    discriminator's ``state_dict``s drawn with numpy from ``seed``, from the
    distributions of the JAX modules' initializers (``_init_leaf``). The
    values differ from a flax init's; the distributions are the same."""
    rng = np.random.default_rng(seed)
    g_entries, d_entries = list(_entries(cfg)), list(_disc_entries())
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
    return _state_dict(_entries(cfg), {"params": params,
                                       "batch_stats": batch_stats})


def discriminator_state_dict_from_jax(params: Tree, spectral: Tree
                                      ) -> Dict[str, torch.Tensor]:
    """JAX discriminator trees -> ``PatchDiscriminator``'s ``state_dict``."""
    return _state_dict(_disc_entries(), {"params": params,
                                         "spectral": spectral})


def vgg_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX VGG16-head params -> ``VGG16Features``'s ``state_dict``."""
    return _state_dict(_vgg_entries(), {"params": params})
