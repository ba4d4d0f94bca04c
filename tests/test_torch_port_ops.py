"""The port's ops against the JAX package's, float32 on the CPU, the same
seeded numpy inputs and weights on both sides.

Tolerance rtol 1e-4, atol 1e-5 unless stated: both sides compute in float32
and differ only in the sum order of convolutions and products.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu import config as jax_config
from vae_gan_mark_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from vae_gan_mark_tpu.ops import film as jax_film
from vae_gan_mark_tpu.ops import warp as jax_warp
from vae_gan_mark_tpu.ops.convblocks import (
    ConvBNRelu as JaxConvBNRelu, DoubleConvBlock as JaxDoubleConv,
    TConv as JaxTConv, TConvBNRelu as JaxTConvBNRelu,
    max_pool_2x2 as jax_max_pool)
from vae_gan_mark_tpu import losses as jax_losses
from vae_gan_mark_tpu.ops.norms import BatchNorm as JaxBatchNorm
from vae_gan_mark_tpu.ops.norms import InstanceNorm as JaxInstanceNorm
from vae_gan_mark_tpu.ops.norms import (
    spectral_normalize as jax_spectral_normalize)
from vae_gan_mark_tpu.ops.pool import adaptive_avg_pool1d as jax_pool
from vae_gan_mark_tpu.ops.resize import interpolate_bilinear as jax_resize
from vae_gan_mark_tpu_torch import config as port_config
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer
from vae_gan_mark_tpu_torch.ops import warp
from vae_gan_mark_tpu_torch.ops.convblocks import (
    ConvBNRelu, DoubleConvBlock, TConv, TConvBNRelu, max_pool_2x2)
from vae_gan_mark_tpu_torch.ops.film import SpatialFiLM, spatial_broadcast
from vae_gan_mark_tpu_torch import losses
from vae_gan_mark_tpu_torch.ops.norms import (
    BatchNorm, InstanceNorm, spectral_normalize)
from vae_gan_mark_tpu_torch.ops.pool import adaptive_avg_pool1d
from vae_gan_mark_tpu_torch.ops.resize import interpolate_bilinear
from vae_gan_mark_tpu_torch.ops.sampling import kl_divergence, reparameterize
from vae_gan_mark_tpu_torch.utils.port_jax import to_port_layout

from torch_port_common import nchw, nhwc

RTOL, ATOL = 1e-4, 1e-5


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def normal(rng, *shape, std=1.0):
    return rng.normal(0, std, shape).astype(np.float32)


def bn_tree(rng, ch):
    params = {"scale": rng.uniform(0.5, 1.5, ch).astype(np.float32),
              "bias": normal(rng, ch, std=0.1)}
    stats = {"mean": normal(rng, ch, std=0.2),
             "var": rng.uniform(0.5, 2.0, ch).astype(np.float32)}
    return params, stats


def load_bn(bn, params, stats):
    bn.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})


def tensor(kind, value):
    return torch.from_numpy(np.ascontiguousarray(to_port_layout(kind, value)))


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("name", sorted(jax_config.VARIANTS))
def test_config_copy_matches(name):
    ours = dataclasses.asdict(port_config.get_config(name))
    theirs = dataclasses.asdict(jax_config.get_config(name))
    assert ours == theirs
    assert port_config.get_config(name).vocab_size == \
        jax_config.get_config(name).vocab_size


def test_config_overrides_and_validation():
    cfg = port_config.get_config("v2", **{"scheduler.patience": 5},
                                 patch_w=224)
    assert cfg.scheduler.patience == 5 and cfg.latent_w == 14
    with pytest.raises(ValueError):
        port_config.get_config("v2", patch_w=100)


def test_tokenizer_matches():
    texts = ["Hello, World!", "", "x" * 80, "Привет ascii", "SALE -50%"]
    for alphabet in (port_config.ASCII_ALPHABET,
                     port_config.ASCII_CYRILLIC_ALPHABET):
        ours = CharTokenizer(alphabet, 60)
        theirs = JaxTokenizer(alphabet, 60)
        np.testing.assert_array_equal(ours.encode(texts), theirs.encode(texts))
        assert ours.decode(ours.encode(texts)[0]) == "Hello, World!"


# ---------------------------------------------------------------- norms, convs
def test_batchnorm_eval_matches():
    rng = np.random.default_rng(0)
    x = normal(rng, 2, 5, 7, 6)
    params, stats = bn_tree(rng, 6)
    ref = JaxBatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, x)
    bn = BatchNorm(6).eval()
    load_bn(bn, params, stats)
    with torch.no_grad():
        close(nhwc(bn(nchw(x))), ref)


def test_batchnorm_train_mode_is_not_ported():
    """BatchNorm train mode against the JAX package's: batch statistics
    with the biased variance, the running update with the unbiased one, and
    the gradient through the batch statistics."""
    rng = np.random.default_rng(14)
    x = normal(rng, 3, 5, 7, 6) * 2.0 + 0.5
    params, stats = bn_tree(rng, 6)
    ref, updated = JaxBatchNorm(use_running_average=False).apply(
        {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    load_bn(bn, params, stats)
    xt = nchw(x).requires_grad_()
    got = bn(xt)
    close(nhwc(got), ref)
    close(bn.running_mean.numpy(), updated["batch_stats"]["mean"])
    close(bn.running_var.numpy(), updated["batch_stats"]["var"])
    got.square().sum().backward()
    ref_grad = jax.grad(lambda x_: jnp.sum(jnp.square(JaxBatchNorm().apply(
        {"params": params, "batch_stats": stats}, x_,
        mutable=["batch_stats"])[0])))(jnp.asarray(x))
    close(nhwc(xt.grad), ref_grad, 1e-4, 1e-4)


def test_instance_norm_matches():
    rng = np.random.default_rng(15)
    x = normal(rng, 2, 6, 10, 5) * 3.0 - 1.0
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": normal(rng, 5, std=0.1)}
    ref = JaxInstanceNorm().apply({"params": params}, x)
    norm = InstanceNorm(5)
    norm.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"])})
    with torch.no_grad():
        close(nhwc(norm(nchw(x))), ref)


@pytest.mark.parametrize("update", [True, False])
def test_spectral_normalize_matches(update):
    """One power iteration (or none) and W / sigma; the gradient flows
    through sigma only, the iteration itself takes none."""
    rng = np.random.default_rng(16)
    kernel = normal(rng, 4, 4, 6, 9, std=0.3)
    u = normal(rng, 9)
    u /= np.linalg.norm(u)
    w_ref, u_ref = jax_spectral_normalize(jnp.asarray(kernel),
                                          jnp.asarray(u), update)
    weight = tensor("conv", kernel).requires_grad_()
    w_sn, u_new = spectral_normalize(weight, torch.from_numpy(u), update)
    close(w_sn.detach().numpy(), to_port_layout("conv", np.asarray(w_ref)))
    close(u_new.numpy(), u_ref, 1e-5, 1e-6)
    if not update:
        np.testing.assert_array_equal(u_new.numpy(), u)
    cot = normal(rng, 4, 4, 6, 9)
    (w_sn * tensor("conv", cot)).sum().backward()
    ref_grad = jax.grad(lambda k: jnp.sum(jax_spectral_normalize(
        k, jnp.asarray(u), update)[0] * cot))(jnp.asarray(kernel))
    close(weight.grad.numpy(), to_port_layout("conv", np.asarray(ref_grad)))


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["l1_loss", "hinge_d_real", "hinge_d_fake",
                                  "hinge_g", "kl_divergence"])
def test_losses_match(name):
    rng = np.random.default_rng(17)
    a, b = normal(rng, 3, 4, 5, 2), normal(rng, 3, 4, 5, 2)
    if name == "l1_loss":
        args = (a, b)
    elif name == "kl_divergence":
        args = (a, 0.5 * b)
    else:
        args = (a,)
    ours = kl_divergence if name == "kl_divergence" else getattr(losses, name)
    got = ours(*(torch.from_numpy(v) for v in args))
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got.numpy(), getattr(jax_losses, name)(*args), 1e-6, 1e-7)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu_matches(stride):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 8, 12, 5)
    kernel, bias = normal(rng, 3, 3, 5, 7, std=0.3), normal(rng, 7)
    bnp, bns = bn_tree(rng, 7)
    ref = JaxConvBNRelu(7, strides=(stride, stride), train=False).apply(
        {"params": {"Conv_0": {"kernel": kernel, "bias": bias},
                    "BatchNorm_0": bnp},
         "batch_stats": {"BatchNorm_0": bns}}, x)
    block = ConvBNRelu(5, 7, stride=stride).eval()
    with torch.no_grad():
        block[0].weight.copy_(tensor("conv", kernel))
        block[0].bias.copy_(torch.from_numpy(bias))
    load_bn(block[1], bnp, bns)
    with torch.no_grad():
        close(nhwc(block(nchw(x))), ref)


def test_double_conv_block_matches():
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 8, 12, 4)
    params, stats, sd = {}, {}, {}
    cin = 4
    for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
        kernel = normal(rng, 3, 3, cin, 6, std=0.3)
        bnp, bns = bn_tree(rng, 6)
        params[f"ConvBNRelu_{j}"] = {"Conv_0": {"kernel": kernel},
                                     "BatchNorm_0": bnp}
        stats[f"ConvBNRelu_{j}"] = {"BatchNorm_0": bns}
        sd[f"{ci}.weight"] = tensor("conv", kernel)
        sd[f"{bi}.weight"] = torch.from_numpy(bnp["scale"])
        sd[f"{bi}.bias"] = torch.from_numpy(bnp["bias"])
        sd[f"{bi}.running_mean"] = torch.from_numpy(bns["mean"])
        sd[f"{bi}.running_var"] = torch.from_numpy(bns["var"])
        cin = 6
    ref = JaxDoubleConv(6, train=False).apply(
        {"params": params, "batch_stats": stats}, x)
    block = DoubleConvBlock(4, 6).eval()
    block.load_state_dict(sd)
    with torch.no_grad():
        close(nhwc(block(nchw(x))), ref)


@pytest.mark.parametrize("ksize,stride,pad", [((2, 2), 2, 0), ((4, 1), 1, 0),
                                              ((4, 4), 2, 1)])
def test_tconv_matches(ksize, stride, pad):
    rng = np.random.default_rng(3)
    x = normal(rng, 2, 3, 5, 6)
    kernel = normal(rng, *ksize, 6, 4, std=0.3)
    bias = normal(rng, 4)
    ref = JaxTConv(4, ksize, strides=(stride, stride),
                   torch_padding=(pad, pad)).apply(
        {"params": {"ConvTranspose_0": {"kernel": kernel, "bias": bias}}}, x)
    layer = TConv(6, 4, ksize, stride=stride, padding=pad)
    with torch.no_grad():
        layer.weight.copy_(tensor("tconv", kernel))
        layer.bias.copy_(torch.from_numpy(bias))
        got = nhwc(layer(nchw(x)))
    assert got.shape == np.asarray(ref).shape
    close(got, ref)


def test_tconv_bn_relu_matches():
    rng = np.random.default_rng(4)
    x = normal(rng, 2, 1, 7, 6)
    kernel, bias = normal(rng, 4, 1, 6, 5, std=0.3), normal(rng, 5)
    bnp, bns = bn_tree(rng, 5)
    ref = JaxTConvBNRelu(5, (4, 1), train=False).apply(
        {"params": {"TConv_0": {"ConvTranspose_0": {"kernel": kernel,
                                                    "bias": bias}},
                    "BatchNorm_0": bnp},
         "batch_stats": {"BatchNorm_0": bns}}, x)
    block = TConvBNRelu(6, 5, (4, 1)).eval()
    with torch.no_grad():
        block[0].weight.copy_(tensor("tconv", kernel))
        block[0].bias.copy_(torch.from_numpy(bias))
    load_bn(block[1], bnp, bns)
    with torch.no_grad():
        close(nhwc(block(nchw(x))), ref)


def test_max_pool_matches():
    x = normal(np.random.default_rng(5), 2, 8, 12, 3)
    close(nhwc(max_pool_2x2(nchw(x))), jax_max_pool(jnp.asarray(x)), 0, 0)


# ---------------------------------------------------------------- pool, resize
@pytest.mark.parametrize("in_len,out_len", [(60, 28), (12, 4), (7, 3)])
def test_adaptive_pool_matches(in_len, out_len):
    x = normal(np.random.default_rng(6), 2, in_len, 5)
    got = adaptive_avg_pool1d(torch.from_numpy(x), out_len)
    close(got.numpy(), jax_pool(jnp.asarray(x), out_len))
    ref = torch.nn.functional.adaptive_avg_pool1d(
        torch.from_numpy(x).transpose(1, 2), out_len).transpose(1, 2)
    close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("src,dst", [((1, 28), (1, 448)), ((1, 28), (8, 56)),
                                     ((4, 28), (16, 112)), ((6, 10), (3, 4)),
                                     ((5, 7), (5, 7))])
def test_bilinear_resize_matches(src, dst):
    x = normal(np.random.default_rng(7), 2, *src, 3)
    got = nhwc(interpolate_bilinear(nchw(x), *dst))
    close(got, jax_resize(jnp.asarray(x), *dst))


# ---------------------------------------------------------------- sampling
def test_reparameterize_with_injected_eps():
    rng = np.random.default_rng(8)
    mu, logvar, eps = (normal(rng, 3, 4, 1, 1) for _ in range(3))
    got = reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                         torch.from_numpy(eps))
    close(got.numpy(), mu + eps * np.exp(0.5 * logvar), 1e-6, 1e-6)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                       generator=g1)
    b = reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                       generator=g2)
    assert torch.equal(a, b) and a.dtype == torch.float32


# ---------------------------------------------------------------- FiLM
def film_setup(seed, h, w, c_main=12, c_t=10, w_t=14):
    rng = np.random.default_rng(seed)
    x = normal(rng, 2, h, w, c_main)
    tmap = normal(rng, 2, 1, w_t, c_t)
    params = {"predict_kernel": normal(rng, 3, 3, c_t, c_t, std=0.2),
              "bn_scale": rng.uniform(0.5, 1.5, c_t).astype(np.float32),
              "bn_bias": normal(rng, c_t, std=0.1),
              "gb_kernel": normal(rng, 1, 1, c_t, 2 * c_main, std=0.3),
              "gb_bias": normal(rng, 2 * c_main, std=0.1)}
    stats = {"bn_mean": normal(rng, c_t, std=0.2),
             "bn_var": rng.uniform(0.5, 2.0, c_t).astype(np.float32)}
    sd = {"param_predictor.0.weight": tensor("conv", params["predict_kernel"]),
          "param_predictor.1.weight": torch.from_numpy(params["bn_scale"]),
          "param_predictor.1.bias": torch.from_numpy(params["bn_bias"]),
          "param_predictor.1.running_mean": torch.from_numpy(stats["bn_mean"]),
          "param_predictor.1.running_var": torch.from_numpy(stats["bn_var"]),
          "param_predictor.3.weight": tensor("conv", params["gb_kernel"]),
          "param_predictor.3.bias": torch.from_numpy(params["gb_bias"])}
    return x, tmap, {"params": params, "batch_stats": stats}, sd


def port_film(sd, c_main, c_t, fast):
    film = SpatialFiLM(c_main, c_t, fast=fast).eval()
    film.load_state_dict(sd)
    return film


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "naive"])
@pytest.mark.parametrize("h,w", [(8, 56), (3, 16), (16, 48)])
def test_spatial_film_matches(fast, h, w):
    x, tmap, variables, sd = film_setup(9, h, w)
    ref = jax_film.SpatialFiLM(num_features_main=12, train=False,
                               fast=fast).apply(variables, x, tmap)
    with torch.no_grad():
        got = nhwc(port_film(sd, 12, 10, fast)(nchw(x), nchw(tmap)))
    close(got, ref)


def test_spatial_film_fast_equals_naive():
    x, tmap, _, sd = film_setup(10, 64, 448, c_main=8, c_t=6, w_t=28)
    with torch.no_grad():
        fast = port_film(sd, 8, 6, True)(nchw(x), nchw(tmap))
        naive = port_film(sd, 8, 6, False)(nchw(x), nchw(tmap))
    close(fast.numpy(), naive.numpy())


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "naive"])
def test_spatial_film_train_statistics_match(fast):
    """Train-mode BN inside the predictor: the row-factored path weights
    its three row types (1, H-2, 1), so its output and running statistics
    equal the JAX package's on the same path and the full-map (naive) ones."""
    h, w = 8, 56
    x, tmap, variables, sd = film_setup(18, h, w)
    outs = {}
    for jax_fast in (True, False):
        outs[jax_fast] = jax_film.SpatialFiLM(
            num_features_main=12, train=True, fast=jax_fast).apply(
            variables, x, tmap, mutable=["batch_stats"])
    film = port_film(sd, 12, 10, fast).train()
    with torch.no_grad():
        got = nhwc(film(nchw(x), nchw(tmap)))
    bn = film.param_predictor[1]
    for jax_fast in (True, False):
        ref, updated = outs[jax_fast]
        close(got, ref)
        close(bn.running_mean.numpy(), updated["batch_stats"]["bn_mean"])
        close(bn.running_var.numpy(), updated["batch_stats"]["bn_var"])


def test_spatial_broadcast_matches():
    emb = normal(np.random.default_rng(11), 3, 5)
    got = spatial_broadcast(torch.from_numpy(emb), 2, 4)
    close(nhwc(got), jax_film.spatial_broadcast(jnp.asarray(emb), 2, 4), 0, 0)


# ---------------------------------------------------------------- warp
# Corners off the pixel grid: a canvas pixel exactly on the quad's border is
# inside or outside by rounding, which may differ between the two sides.
QUADS = np.array([[[20.3, 15.2], [110.4, 18.1], [108.2, 60.3], [18.1, 57.4]],
                  [[5.2, 40.3], [130.1, 5.4], [135.3, 85.2], [10.4, 70.1]]],
                 np.float32)


def test_solve_homography_matches():
    rect = np.array([[0, 0], [447, 0], [447, 63], [0, 63]], np.float32)
    got = warp.solve_homography(torch.from_numpy(rect),
                                torch.from_numpy(QUADS))
    ref = np.stack([np.asarray(jax_warp.solve_homography(
        jnp.asarray(rect), jnp.asarray(q))) for q in QUADS])
    close(got.numpy(), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_perspective_crop_matches(dtype):
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255 if dtype == np.uint8 else 1,
                         (2, 90, 140, 3)).astype(dtype)
    got = warp.perspective_crop_batch(torch.from_numpy(images),
                                      torch.from_numpy(QUADS), 32, 64)
    ref = jax_warp.perspective_crop_batch(jnp.asarray(images),
                                          jnp.asarray(QUADS), 32, 64)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64, 3)
    close(got.numpy(), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_perspective_unwarp_matches(dtype):
    rng = np.random.default_rng(13)
    scale = 255 if dtype == np.uint8 else 1
    patch = (rng.uniform(0, 1, (32, 64, 3)) * scale).astype(np.float32)
    canvas = rng.uniform(0, scale, (90, 140, 3)).astype(dtype)
    got = warp.perspective_unwarp(torch.from_numpy(patch),
                                  torch.from_numpy(QUADS[0]),
                                  torch.from_numpy(canvas), 90, 140)
    ref = np.asarray(jax_warp.perspective_unwarp(
        jnp.asarray(patch), jnp.asarray(QUADS[0]), jnp.asarray(canvas),
        90, 140))
    assert got.dtype == torch.from_numpy(canvas).dtype
    if dtype == np.uint8:
        # Truncation to uint8 can flip by one where the two sides' floats
        # straddle an integer.
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    else:
        close(got.numpy(), ref, 1e-4, 1e-4)
    # BORDER_TRANSPARENT: far corners keep the canvas.
    np.testing.assert_array_equal(got.numpy()[85:, 135:], canvas[85:, 135:])
