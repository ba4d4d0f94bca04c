"""The opt-in projection-conditional discriminator head against the JAX
package's, float32 on the CPU at the tiny geometry: the head for int
tokens (``cond_embed``, the mean over all L tokens, PAD included) and for
float sentence embeddings (``cond_dense``), the bridge's cond leaves, the
default-off tree, the train steps of v2 and of vanilla with the head, the
full-loss eval step, and the train and eval CLIs with ``--set
conditional_disc=1``.

Tolerances: the head alone rtol 1e-4, atol 1e-5 (five convolutions and two
small products in float32); the train steps are held as
test_torch_port_train.py holds them (3 steps, metrics rtol 1e-3), with the
default fused D forward. Two D forwards (``fused_disc_forward=False``)
with the head are not held here: at these weights and batches D's first
Adam update, lr * g / (|g| + eps), turns the two sides' rounding in a few
near-zero gradients into weight differences of up to 2 lr, and one of D's
LeakyReLU inputs lies close enough to its kink that G's gradient through
the updated D then differs past the held tolerances, while the port's
d hinge_g / d fake from the JAX package's D state agrees with JAX's.

vanilla with the head is held for 2 steps: at these weights the head
shifts D's logits far past the hinge's margin for most patches, and from
the third step on the run is chaotic in float32 (the port against itself,
with the real images scaled by 1 + 1e-7 noise, moves as far as the port
and JAX differ there)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models import vaegan as jax_vaegan
from vae_gan_mark_tpu.models.discriminator import (
    PatchDiscriminator as JaxDiscriminator)
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.train.step import (
    build_eval_step as jax_build_eval_step)
from vae_gan_mark_tpu_torch import cli
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.eval import __main__ as eval_cli
from vae_gan_mark_tpu_torch.models import PatchDiscriminator
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_eval_step, init_state_dicts)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    disc_cond_args, discriminator_state_dict_from_jax,
    random_discriminator_tree)

from torch_port_common import (
    KL_WEIGHT, METRIC_TOL, PLAIN_ZERO_GRADIENT, STEPS, TINY, TRAIN,
    assert_train_steps_match, jax_init, make_batch, nhwc, port_from_jax)

HEAD_TOL = dict(rtol=1e-4, atol=1e-5)
CONDS = {"char": ("v2", {}), "sbert": ("vanilla", {})}


def head_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, 32, 64, 3)).astype(np.float32)
    if cfg.text_encoder == "sbert":
        return x, rng.normal(0, 1, (3, cfg.sbert_dim)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (3, cfg.max_text_len))
    tokens[:, 7:] = 0                                   # a PAD tail
    return x, tokens.astype(np.int32)


def jax_shapes(module, *args):
    variables = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return jax.tree.map(lambda v: tuple(v.shape), dict(variables))


@pytest.mark.parametrize("cond", sorted(CONDS))
def test_head_matches_jax(cond):
    """Logits, the spectral u and the gradients of every parameter, the
    head's included, for one cond type; the tree has that branch only."""
    variant, overrides = CONDS[cond]
    cfg = get_config(variant, **TINY, conditional_disc=True)
    x, c = head_inputs(cfg, 1)
    params, spectral = random_discriminator_tree(5, cfg)
    jax_d = JaxDiscriminator(cond_vocab=cfg.vocab_size)
    assert jax.tree.map(np.shape, {"params": params, "spectral": spectral}) \
        == jax_shapes(jax_d, x, c)
    branch = "cond_dense" if cond == "sbert" else "cond_embed"
    assert {k for k in params if k.startswith("cond")} == {branch,
                                                          "cond_proj"}

    def jax_loss(p):
        out, upd = jax_d.apply({"params": p, "spectral": spectral}, x, c,
                               mutable=["spectral"])
        return jnp.sum(out * np.linspace(-1, 1, out.size).reshape(
            out.shape)), (out, upd)

    (_, (ref, updated)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    disc = PatchDiscriminator(**disc_cond_args(cfg))
    disc.load_state_dict(discriminator_state_dict_from_jax(params, spectral,
                                                           cfg))
    out = disc(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **HEAD_TOL)
    weights = torch.from_numpy(np.linspace(-1, 1, out.numel()).reshape(
        nhwc(out).shape).astype(np.float32)).permute(0, 3, 1, 2)
    (out * weights).sum().backward()
    got = {k: p.grad for k, p in disc.named_parameters()}
    want = discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, ref_grads),
        jax.tree.map(np.asarray, updated["spectral"]), cfg)
    for key, grad in got.items():
        scale = float(want[key].abs().max())
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(),
                                   rtol=HEAD_TOL["rtol"],
                                   atol=max(HEAD_TOL["atol"], 1e-5 * scale),
                                   err_msg=key)
    for key, u in disc.state_dict().items():
        if "weight_u" in key:
            np.testing.assert_allclose(u.numpy(), want[key].numpy(),
                                       **HEAD_TOL)


def test_pad_counts_in_the_token_mean():
    """``cond_embed`` averages over all L tokens: PAD rows (not zeroed)
    move the result, as in the JAX package."""
    disc = PatchDiscriminator(cond_vocab=8)
    tokens = torch.tensor([[1, 2, 0, 0]])
    e = disc.cond_embed(tokens).mean(dim=1)
    assert torch.allclose(e, (disc.cond_embed.weight[1]
                              + disc.cond_embed.weight[2]
                              + 2 * disc.cond_embed.weight[0]) / 4)


def test_default_off_has_no_cond_leaf():
    cfg = get_config("v2", **TINY)
    x = np.zeros((2, 32, 64, 3), np.float32)
    ref = jax_shapes(JaxDiscriminator(cond_vocab=0), x)
    params, _ = random_discriminator_tree(0, cfg)
    assert not any("cond" in k for k in ref["params"])
    assert jax.tree.map(np.shape, params) == ref["params"]
    _, d_sd = init_state_dicts(cfg, seed=0)
    assert not any("cond" in k for k in d_sd)
    assert d_sd.keys() == PatchDiscriminator().state_dict().keys()
    # cond is ignored without the head.
    disc = PatchDiscriminator()
    xt = torch.rand(2, 32, 64, 3)
    assert torch.equal(disc(xt, torch.ones(2, 4, dtype=torch.long),
                            update_sn=False), disc(xt, update_sn=False))


@pytest.mark.parametrize("variant", ["v2", "vanilla"])
def test_head_is_text_sensitive(variant):
    cfg = get_config(variant, **TINY, conditional_disc=True)
    _, d_sd = init_state_dicts(cfg, seed=1)
    disc = PatchDiscriminator(**disc_cond_args(cfg))
    disc.load_state_dict(d_sd)
    x, a = head_inputs(cfg, 2)
    _, b = head_inputs(cfg, 3)
    with torch.no_grad():
        out_a = disc(torch.from_numpy(x), torch.from_numpy(a),
                     update_sn=False)
        out_b = disc(torch.from_numpy(x), torch.from_numpy(b),
                     update_sn=False)
        plain = disc(torch.from_numpy(x), update_sn=False)
    assert out_a.shape == out_b.shape == plain.shape
    assert float((out_a - out_b).abs().max()) > 0
    # The head adds one number a sample, the same at every patch.
    shift = out_a - plain
    assert torch.allclose(shift, shift[:, :, :1, :1].expand_as(shift),
                          atol=1e-6)


@pytest.fixture(scope="module")
def vgg():
    return load_vgg_params()


@pytest.mark.parametrize("variant", ["v2", "vanilla"])
def test_conditional_train_steps_match_jax(vgg, variant):
    """The default fused D forward; vanilla for 2 steps (see the module
    doc)."""
    jax_state = jax_init(variant, conditional_disc=True)
    assert any(k.startswith("cond") for k in jax_state.d_params)
    plain = variant == "vanilla"
    state = assert_train_steps_match(
        variant, jax_state, vgg, steps=2 if plain else STEPS,
        zero_gradient=PLAIN_ZERO_GRADIENT if plain else (),
        conditional_disc=True)
    # The head trained.
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for k, p in state.discriminator.named_parameters()
               if k.startswith("cond"))


def test_conditional_eval_step_matches_jax(vgg, monkeypatch):
    """v2's full-loss eval step reads D with the text."""
    jax_state = jax_init("v2", conditional_disc=True)
    cfg, state, port_vgg = port_from_jax("v2", jax_state, vgg,
                                         conditional_disc=True)
    batch = make_batch(cfg, 21)

    def fixed_noise(rng, mu, logvar):
        return (mu.astype(jnp.float32) + batch["eps"]
                * jnp.exp(0.5 * logvar.astype(jnp.float32))).astype(mu.dtype)

    monkeypatch.setattr(jax_vaegan, "reparameterize", fixed_noise)
    jcfg = jax_get_config("v2", **TRAIN, conditional_disc=True)
    ref, _ = jax.jit(jax_build_eval_step(jcfg))(
        jax_state, vgg, {k: v for k, v in batch.items() if k != "eps"},
        jax.random.PRNGKey(2), jnp.float32(KL_WEIGHT))
    got, _ = build_eval_step(cfg)(state, port_vgg,
                                  batch_to_device(batch, "cpu"),
                                  torch.Generator().manual_seed(0),
                                  KL_WEIGHT)
    assert set(got) == set(ref) and "loss_D" in got
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   err_msg=key, **METRIC_TOL)


def test_clis_train_and_evaluate_with_the_head(tmp_path, capsys):
    sets = [a for k, v in TINY.items() for a in (
        "--set", f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}")]
    args = ["--variant", "v2", "--workdir", str(tmp_path), "--device",
            "cpu", "--set", "conditional_disc=1"] + sets
    cli.main(args + ["--synthetic", "--synthetic-samples", "8",
                     "--batch-size", "4", "--epochs", "1"])
    assert "done; best val recon" in capsys.readouterr().out
    saved = torch.load(tmp_path / "last_checkpoint" / "state.pt",
                       weights_only=False)
    assert {"cond_embed.weight", "cond_proj.weight"} <= set(
        saved["discriminator"])
    eval_cli.main(args + ["--synthetic", "--synthetic-samples", "8",
                          "--batch-size", "4"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["samples"] == 8 and np.isfinite(result["loss_D"])


def test_d_gradients_on_the_cpu_match_float64(monkeypatch, capsys):
    """D's parameter gradients on the CPU (vanilla with the head at the
    tiny geometry, the JAX init's weights, real images and the generator's
    train-mode output, the fused forward's hinge loss) against the same D
    written out plainly in float64: within 1e-4 of each tensor's largest
    value (read 1.0e-5). The batch goes to NCHW memory first
    (``nhwc_to_nchw``); the test prints what a channels-last view gives
    instead (read 2.6e-2 on a Xeon CPU with AMX, where oneDNN takes
    another path for it)."""
    import torch.nn.functional as F

    from vae_gan_mark_tpu_torch.losses import hinge_d_fake, hinge_d_real
    from vae_gan_mark_tpu_torch.models import discriminator

    jax_state = jax_init("vanilla", conditional_disc=True)
    cfg, state, _ = port_from_jax("vanilla", jax_state, load_vgg_params(),
                                  conditional_disc=True)
    batch = make_batch(cfg, 10)
    state.generator.train()
    with torch.no_grad():
        fake, _, _ = state.generator(
            torch.from_numpy(batch["ru"]), torch.from_numpy(batch["mask"]),
            torch.from_numpy(batch["text"]),
            eps=torch.from_numpy(batch["eps"]))
    x = torch.cat([torch.from_numpy(batch["en"]), fake])
    cond = torch.cat([torch.from_numpy(batch["text"])] * 2)
    d_sd = state.discriminator.state_dict()

    def port_grads():
        disc = PatchDiscriminator(**disc_cond_args(cfg))
        disc.load_state_dict(d_sd)
        real, fake_ = disc(x, cond).chunk(2)
        (0.5 * (hinge_d_real(real) + hinge_d_fake(fake_))).backward()
        return {k: p.grad.double() for k, p in disc.named_parameters()}

    sd = {k: v.double().contiguous().requires_grad_("weight_u" not in k)
          for k, v in d_sd.items()}

    def sn(i):
        w, u = sd[f"body.{i}.weight_orig"], sd[f"body.{i}.weight_u"]
        wm = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = wm.t() @ u
            v = v / (v.norm() + 1e-12)
            u = wm @ v
            u = u / (u.norm() + 1e-12)
        return w / torch.dot(u, wm @ v)

    def inorm(y, i):
        m = y.mean((2, 3), keepdim=True)
        var = ((y - m) ** 2).mean((2, 3), keepdim=True)
        return ((y - m) / torch.sqrt(var + 1e-5)
                * sd[f"body.{i}.weight"].view(1, -1, 1, 1)
                + sd[f"body.{i}.bias"].view(1, -1, 1, 1))

    y = x.double().permute(0, 3, 1, 2).contiguous()
    y = F.leaky_relu(F.conv2d(y, sn(0), sd["body.0.bias"], 2, 1), 0.2)
    for conv, norm in ((2, 3), (5, 6), (8, 9)):
        y = F.leaky_relu(inorm(F.conv2d(y, sn(conv), sd[f"body.{conv}.bias"],
                                        2, 1), norm), 0.2)
    logits = F.conv2d(y, sd["body.11.weight"], sd["body.11.bias"], 1, 1)
    proj = F.linear(F.linear(cond.double(), sd["cond_dense.weight"],
                             sd["cond_dense.bias"]), sd["cond_proj.weight"])
    logits = logits + (y.mean((2, 3)) * proj).sum(1)[:, None, None, None]
    real, fake_ = logits.chunk(2)
    (0.5 * (F.relu(1 - real).mean() + F.relu(1 + fake_).mean())).backward()

    def errors(grads):
        # The conv biases ahead of an InstanceNorm have a zero gradient in
        # exact arithmetic: rounding noise on both sides, left out.
        return {k: float((g - sd[k].grad).abs().max()
                         / sd[k].grad.abs().max())
                for k, g in grads.items()
                if k not in ("body.2.bias", "body.5.bias", "body.8.bias")}

    got = errors(port_grads())
    monkeypatch.setattr(discriminator, "nhwc_to_nchw",
                        lambda t: t.permute(0, 3, 1, 2))
    view = errors(port_grads())
    with capsys.disabled():
        print(f"\nD's gradients against float64, worst tensor: NCHW "
              f"{max(got.values()):.2e}, channels-last view "
              f"{max(view.values()):.2e}")
    for key, err in got.items():
        assert err <= 1e-4, (key, err)
