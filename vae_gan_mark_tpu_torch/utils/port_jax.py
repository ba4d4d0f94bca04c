"""Weight bridge: the JAX generator's ``params``/``batch_stats`` trees, as
nested dicts of numpy arrays, -> this package's ``state_dict``.

The port's keys are the reference's (``style_vae_encoder_module.e_conv1.0
.weight``, ``char_text_encoder_module.rnn.weight_hh_l0_reverse``, ...), so the
JAX package's ``utils/port_torch.py:port_v2_generator`` is this bridge's
inverse. Layout changes:

* Conv kernels HWIO -> OIHW.
* ConvTranspose kernels: flip both spatial axes, then (kh, kw, in, out) ->
  (in, out, kh, kw).
* GRU ``w_ih`` (in, 3H) and ``w_hh`` (H, 3H) transposed to torch's (3H, .).
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

One table (``_entries``) lists every leaf with its JAX path, its port key,
its layout change and its JAX shape; the bridge and the seeded random init
both read it. Covers the char-conditioned U-Net generators
(v2 with FiLM, unet without).
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig

Tree = Dict[str, object]


class Entry(NamedTuple):
    collection: str            # "params" or "batch_stats"
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
    else:                                           # biases, running means
        value = rng.normal(0.0, 0.1, e.shape)
    return value.astype(np.float32)


def random_jax_tree(cfg: VariantConfig, seed: int) -> Tuple[Tree, Tree]:
    """Seeded random (params, batch_stats) numpy trees in the JAX
    generator's layout: He-normal conv kernels, torch's GRU init, BN
    variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for e in _entries(cfg):
        _set(trees[e.collection], e.path, _random_leaf(rng, e))
    return trees["params"], trees["batch_stats"]


def state_dict_from_jax(params: Tree, batch_stats: Tree,
                        cfg: VariantConfig) -> Dict[str, torch.Tensor]:
    """JAX generator trees (numpy leaves) -> the port's ``state_dict``."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd = {}
    for e in _entries(cfg):
        value = np.asarray(_get(trees[e.collection], e.path), np.float32)
        if value.shape != e.shape:
            raise ValueError(f"{'/'.join(e.path)}: shape {value.shape}, "
                             f"expected {e.shape}")
        sd[e.key] = torch.from_numpy(
            np.ascontiguousarray(to_port_layout(e.kind, value)))
    return sd
