"""The port's generator modules against the JAX package's, float32 on the
CPU, with the same seeded weights (``utils/port_jax.py``).

* Encoder, text encoder and decoder at the tiny geometry of
  tests/test_train_fast.py: rtol 1e-4, atol 1e-5 (float32 on both sides,
  sum order of the convolutions only).
* The whole v2 generator with injected ``eps`` at full width (448x64, B=2),
  and the tiny v2 and unet generators: rtol 1e-3, atol 2e-4, the tolerance
  of tests/test_torch_parity.py (some 20 convolutions deep).
* The discriminator (logits and spectral ``u``), the VGG16 head and the
  perceptual loss with its gradient, at the tiny geometry: rtol 1e-4,
  atol 1e-5 (float32 on both sides, five to seven convolutions deep).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.losses import perceptual_loss as jax_perceptual_loss
from vae_gan_mark_tpu.models.decoders import UNetStyleDecoder as JaxDecoder
from vae_gan_mark_tpu.models.discriminator import (
    PatchDiscriminator as JaxDiscriminator)
from vae_gan_mark_tpu.models.vgg import vgg_features as jax_vgg_features
from vae_gan_mark_tpu.models.encoders import UNetEncoder as JaxEncoder
from vae_gan_mark_tpu.models.text_encoders import (
    CharTextEncoder as JaxTextEncoder)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.losses import perceptual_loss
from vae_gan_mark_tpu_torch.models import (
    PatchDiscriminator, VAEGANGenerator, VGG16Features)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, random_discriminator_tree,
    random_vgg_tree, vgg_state_dict_from_jax)
from vae_gan_mark_tpu_torch.ops.precision import precision_scope, torch_dtype

from torch_port_common import TINY, Pair, nchw, nhwc

MOD_RTOL, MOD_ATOL = 1e-4, 1e-5
GEN_RTOL, GEN_ATOL = 1e-3, 2e-4


@pytest.fixture(scope="module")
def tiny():
    return Pair("v2", seed=0, **TINY)


def test_encoder_matches(tiny):
    cfg = tiny.jax_cfg
    image, mask, _, _ = tiny.inputs(2)
    x = np.concatenate([image, mask], -1)
    mu, logvar, skips = JaxEncoder(
        chans=cfg.enc_chans, bottleneck_ch=cfg.bottleneck_ch, z_ch=cfg.z_ch,
        train=False).apply(tiny.variables("encoder"), x)
    with torch.no_grad():
        pmu, plogvar, pskips = tiny.port.style_vae_encoder_module(nchw(x))
    np.testing.assert_allclose(nhwc(pmu), mu, MOD_RTOL, MOD_ATOL)
    np.testing.assert_allclose(nhwc(plogvar), logvar, MOD_RTOL, MOD_ATOL)
    assert len(pskips) == len(skips)
    for ours, theirs in zip(pskips, skips):
        np.testing.assert_allclose(nhwc(ours), theirs, MOD_RTOL, MOD_ATOL)


def test_text_encoder_matches(tiny):
    cfg = tiny.jax_cfg
    _, _, tokens, _ = tiny.inputs(3)
    ref = JaxTextEncoder(
        vocab_size=cfg.vocab_size, out_width=cfg.text_feature_width,
        emb_dim=cfg.char_emb_dim, rnn_hidden=cfg.char_rnn_hidden,
        rnn_layers=cfg.char_rnn_layers, dropout=cfg.char_rnn_dropout,
        train=False).apply(tiny.variables("text_encoder"), tokens)
    with torch.no_grad():
        got = tiny.port.char_text_encoder_module(
            torch.from_numpy(tokens.astype(np.int64)))
    assert nhwc(got).shape == (3, 1, cfg.text_feature_width,
                               2 * cfg.char_rnn_hidden)
    np.testing.assert_allclose(nhwc(got), ref, MOD_RTOL, MOD_ATOL)


def test_pad_tokens_embed_to_zero(tiny):
    module = tiny.port.char_text_encoder_module
    tokens = torch.tensor([[5, 0, 7, 0]])
    emb = module.embedding(tokens) * (tokens != 0)[..., None].float()
    assert torch.all(emb[0, 1] == 0) and torch.all(emb[0, 3] == 0)


@pytest.mark.parametrize("fast_film", [True, False], ids=["fast", "naive"])
def test_decoder_matches(tiny, fast_film):
    cfg = tiny.jax_cfg
    rng = np.random.default_rng(3)
    z = rng.normal(0, 1, (2, 1, 1, cfg.z_ch)).astype(np.float32)
    tmap = rng.normal(0, 1, (2, 1, cfg.text_feature_width,
                             2 * cfg.char_rnn_hidden)).astype(np.float32)
    skips = [rng.normal(0, 1, (2, cfg.patch_h >> i, cfg.patch_w >> i, c)
                        ).astype(np.float32)
             for i, c in enumerate(cfg.enc_chans)]
    ref = JaxDecoder(latent_h=cfg.latent_h, latent_w=cfg.latent_w,
                     skip_chans=cfg.enc_chans, bottleneck_ch=cfg.bottleneck_ch,
                     out_ch=cfg.out_ch, use_film=True, fast_film=fast_film,
                     train=False).apply(tiny.variables("decoder"), z, tmap,
                                        skips)
    decoder = tiny.port.image_vae_decoder_module
    for n in range(1, cfg.num_levels + 1):
        getattr(decoder, f"spatial_film{n}").fast = fast_film
    with torch.no_grad():
        got = decoder(nchw(z), nchw(tmap), [nchw(s) for s in skips])
    for n in range(1, cfg.num_levels + 1):
        getattr(decoder, f"spatial_film{n}").fast = True
    np.testing.assert_allclose(nhwc(got), ref, MOD_RTOL, MOD_ATOL)


@pytest.mark.parametrize("variant", ["v2", "unet"])
def test_tiny_generator_matches(variant):
    pair = Pair(variant, seed=1, **TINY)
    args = pair.inputs(3, seed=4)
    for got, ref in zip(pair.run_port(*args), pair.run_jax(*args)):
        np.testing.assert_allclose(got, ref, GEN_RTOL, GEN_ATOL)


def test_full_width_v2_generator_matches():
    """The slice at its real width: v2, 448x64, B=2, injected eps."""
    pair = Pair("v2", seed=2, compute_dtype="float32")
    assert (pair.cfg.patch_w, pair.cfg.patch_h) == (448, 64)
    args = pair.inputs(2, seed=5)
    recon, mu, logvar = pair.run_port(*args)
    ref_recon, ref_mu, ref_logvar = pair.run_jax(*args)
    assert recon.shape == (2, 64, 448, 3) and recon.dtype == np.float32
    assert mu.shape == logvar.shape == (2, 1, 1, 128)
    np.testing.assert_allclose(mu, ref_mu, GEN_RTOL, GEN_ATOL)
    np.testing.assert_allclose(logvar, ref_logvar, GEN_RTOL, GEN_ATOL)
    np.testing.assert_allclose(recon, ref_recon, GEN_RTOL, GEN_ATOL)


def test_bfloat16_generator_runs_close_to_float32():
    """bf16 casts the convolutions only; the outputs stay float32."""
    pair = Pair("v2", seed=3, **TINY)
    bf16_cfg = get_config("v2", **{**TINY, "compute_dtype": "bfloat16"})
    bf16 = VAEGANGenerator(bf16_cfg).eval()
    bf16.load_state_dict(pair.state_dict)
    args = pair.inputs(2, seed=6)
    ref = pair.run_port(*args)[0]
    with torch.no_grad():
        recon, mu, _ = bf16(*(torch.from_numpy(a) for a in args[:2]),
                            torch.from_numpy(args[2].astype(np.int64)),
                            eps=torch.from_numpy(args[3]))
    assert recon.dtype == mu.dtype == torch.float32
    assert np.abs(recon.numpy() - ref).max() < 0.05


def test_generator_draws_noise_from_generator(tiny):
    image, mask, tokens, _ = tiny.inputs(2)
    args = (torch.from_numpy(image), torch.from_numpy(mask),
            torch.from_numpy(tokens.astype(np.int64)))
    with torch.no_grad():
        a = tiny.port(*args, generator=torch.Generator().manual_seed(1))[0]
        b = tiny.port(*args, generator=torch.Generator().manual_seed(1))[0]
        c = tiny.port(*args, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def images(seed, batch=2, h=32, w=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("update_sn", [True, False])
def test_discriminator_matches(update_sn):
    params, spectral = random_discriminator_tree(seed=4)
    x = images(7)
    ref, updated = JaxDiscriminator(update_sn=update_sn).apply(
        {"params": params, "spectral": spectral}, x, mutable=["spectral"])
    disc = PatchDiscriminator()
    disc.load_state_dict(discriminator_state_dict_from_jax(params, spectral))
    with torch.no_grad():
        got = disc(torch.from_numpy(x), update_sn=update_sn)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 1, 3)
    np.testing.assert_allclose(nhwc(got), ref, MOD_RTOL, MOD_ATOL)
    for i, idx in enumerate((0, 2, 5, 8)):
        u = disc.body[idx].weight_u.numpy()
        ref_u = np.asarray(updated["spectral"][f"SpectralConv_{i}"]["u"])
        np.testing.assert_allclose(u, ref_u, MOD_RTOL, MOD_ATOL)
        if not update_sn:
            np.testing.assert_array_equal(
                u, spectral[f"SpectralConv_{i}"]["u"])


def test_conditional_discriminator_is_not_ported():
    """The conditional head is ported: ``cond_vocab=91`` (v2's vocabulary)
    builds ``cond_embed`` and ``cond_proj`` and reads int tokens
    (tests/test_torch_port_cond_disc.py holds it against JAX)."""
    disc = PatchDiscriminator(cond_vocab=91)
    assert {"cond_embed.weight", "cond_proj.weight"} <= set(
        disc.state_dict())
    assert tuple(disc.cond_embed.weight.shape) == (91, 64)
    tokens = torch.randint(0, 91, (2, 12))
    with torch.no_grad():
        out = disc(torch.from_numpy(images(3)), tokens, update_sn=False)
    assert out.shape == (2, 1, 1, 3)


def test_vgg_and_perceptual_loss_match():
    """relu3_3 features, the perceptual L1 and its gradient through the
    generated image; VGG's own parameters take none."""
    params = random_vgg_tree(seed=5)
    fake, real = images(8), images(9)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(params))
    assert not any(p.requires_grad for p in vgg.parameters())
    with torch.no_grad():
        feats = vgg(torch.from_numpy(fake))
    np.testing.assert_allclose(nhwc(feats), jax_vgg_features(params, fake),
                               MOD_RTOL, MOD_ATOL)
    fake_t = torch.from_numpy(fake).requires_grad_()
    loss = perceptual_loss(vgg, fake_t, torch.from_numpy(real))
    loss.backward()
    ref, ref_grad = jax.value_and_grad(
        lambda f: jax_perceptual_loss(params, f, jnp.asarray(real)))(
        jnp.asarray(fake))
    np.testing.assert_allclose(float(loss.detach()), float(ref), MOD_RTOL,
                               MOD_ATOL)
    np.testing.assert_allclose(fake_t.grad.numpy(), np.asarray(ref_grad),
                               MOD_RTOL, MOD_ATOL)
    assert all(p.grad is None for p in vgg.parameters())


# Every variant is ported now, oldv with the sbert text path too (a U-Net
# encoder whose skips go unused and the plain decoder, as in JAX): each
# builds and matches the JAX forward at the tiny geometry.
@pytest.mark.parametrize("variant,overrides", [
    ("vanilla", {}), ("lr_sh", {}), ("oldv", {"text_encoder": "sbert"})],
    ids=["vanilla", "lr_sh", "oldv"])
def test_other_variants_are_not_ported(variant, overrides):
    if variant == "oldv":
        overrides = dict(overrides, enc_chans=(8, 16, 24))
    pair = Pair(variant, seed=6, **{**TINY, **overrides})
    args = pair.inputs(2, seed=7)
    got, ref = pair.run_port(*args), pair.run_jax(*args)
    assert got[0].shape == ref[0].shape == (2, 32, 64, 3)
    for ours, theirs in zip(got, ref):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, GEN_RTOL, GEN_ATOL)


def test_precision_scope_turns_tf32_off_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    with precision_scope(torch_dtype("float32")):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    with precision_scope(torch_dtype("bfloat16")):
        assert torch.backends.cudnn.allow_tf32
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before
    with pytest.raises(ValueError):
        torch_dtype("float16")
