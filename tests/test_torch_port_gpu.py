"""Tests of the port that need an NVIDIA GPU (sm_90a) and ``nvcc``; each
skips where ``torch.cuda.is_available()`` is false.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch. There, without the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VGG16Features
from vae_gan_mark_tpu_torch.ops import conv_probe, gru
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.train import (
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, random_discriminator_tree,
    random_jax_tree, random_vgg_tree, state_dict_from_jax,
    vgg_state_dict_from_jax)

pytestmark = pytest.mark.gpu

TINY = dict(patch_h=32, patch_w=64, compute_dtype="float32",
            enc_chans=(8, 16, 24, 32), bottleneck_ch=48, z_ch=16,
            char_emb_dim=16, char_rnn_hidden=16, max_text_len=12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("batch", [1, 16, 128])
def test_kernel_matches_plain(card, hidden, batch):
    """atol 1e-5, rtol 1e-4: the product's sum order differs."""
    gen = torch.Generator(device=card).manual_seed(hidden + batch)
    x_proj = torch.randn(60, batch, 3 * hidden, device=card, generator=gen)
    w_hh = (torch.rand(3 * hidden, hidden, device=card, generator=gen)
            - 0.5) / hidden ** 0.5
    b_hh = torch.rand(3 * hidden, device=card, generator=gen) - 0.5
    for reverse in (False, True):
        before = gru.KERNEL.launches
        got = gru.gru_recurrence(x_proj, w_hh, b_hh, reverse)
        torch.cuda.synchronize()
        assert gru.KERNEL.launches == before + 1
        ref = gru.gru_recurrence_plain(x_proj, w_hh, b_hh, reverse)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("batch", [1, 16, 128])
def test_bidirectional_kernel_matches_plain(card, hidden, batch):
    """Both directions of a layer in one forward launch against two plain
    recurrences (left to right, right to left), atol 1e-5, rtol 1e-4 as for
    one direction. At B=128 the pair takes 32-row tiles."""
    gen = torch.Generator(device=card).manual_seed(3 * hidden + batch)
    dirs = []
    for _ in range(2):
        x_proj = torch.randn(60, batch, 3 * hidden, device=card,
                             generator=gen)
        w_hh = (torch.rand(3 * hidden, hidden, device=card, generator=gen)
                - 0.5) / hidden ** 0.5
        b_hh = torch.rand(3 * hidden, device=card, generator=gen) - 0.5
        dirs.append((x_proj, w_hh, b_hh))
    before = gru.KERNEL.launches
    got = gru.gru_bidirectional_forward(*dirs)
    torch.cuda.synchronize()
    assert gru.KERNEL.launches == before + 1
    for d, reverse, got_d in zip(dirs, (False, True), got):
        ref = gru.gru_recurrence_plain(*d, reverse)
        torch.testing.assert_close(got_d, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("hidden", [12, 1024])
def test_kernel_refuses_unsupported_hidden(card, hidden):
    """The kernel is built for H in {16, 32, 64, 128, 256} only."""
    x_proj = torch.zeros(4, 2, 3 * hidden, device=card)
    with pytest.raises(RuntimeError, match="gru_forward launch failed"):
        gru.gru_recurrence(x_proj, torch.zeros(3 * hidden, hidden,
                                               device=card),
                           torch.zeros(3 * hidden, device=card))


def test_engine_on_card_matches_cpu(card):
    """Same seed, same noise: the card's float32 output (TF32 off) equals
    the CPU's to atol 1e-4 (cuDNN's and the CPU's sum orders differ)."""
    cfg = get_config("v2", **TINY)
    params, stats = random_jax_tree(cfg, seed=0)
    sd = state_dict_from_jax(params, stats, cfg)
    rng = np.random.default_rng(0)
    ru = rng.uniform(0, 1, (5, 32, 64, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (5, 32, 64, 1)).astype(np.float32)
    texts = ["a", "bb", "ccc", "dddd", "eeeee"]
    before = gru.KERNEL.launches
    out = InferenceEngine(cfg, sd, batch_size=2, device=card).generate(
        ru, mask, texts)
    assert gru.KERNEL.launches - before == 2 * 3       # 3 chunks
    ref = InferenceEngine(cfg, sd, batch_size=2, device="cpu").generate(
        ru, mask, texts)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("batch", [1, 16, 128])
def test_backward_kernel_matches_plain(card, hidden, batch):
    """atol 1e-4, rtol 1e-4: dW_hh and db_hh sum over L*B rows (up to 7680)
    in another order than the plain loop; dx_proj agrees to 1e-6."""
    gen = torch.Generator(device=card).manual_seed(hidden * batch)
    x_proj = torch.randn(60, batch, 3 * hidden, device=card, generator=gen)
    w_hh = (torch.rand(3 * hidden, hidden, device=card, generator=gen)
            - 0.5) / hidden ** 0.5
    b_hh = torch.rand(3 * hidden, device=card, generator=gen) - 0.5
    for reverse in (False, True):
        outs = gru.gru_recurrence(x_proj, w_hh, b_hh, reverse)
        grad = torch.randn(outs.shape, device=card, generator=gen)
        before = gru.BACKWARD_KERNEL.launches
        got = gru.gru_recurrence_backward(x_proj, w_hh, b_hh, outs, grad,
                                          reverse)
        torch.cuda.synchronize()
        assert gru.BACKWARD_KERNEL.launches == before + 1
        ref = gru.gru_backward_plain(x_proj, w_hh, b_hh, outs, grad, reverse)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hidden", [16, 256])
@pytest.mark.parametrize("batch", [1, 16, 128])
def test_bidirectional_backward_kernel_matches_plain(card, hidden, batch):
    """Both directions of a layer in one backward launch against two plain
    backwards (left to right, right to left), atol 1e-4, rtol 1e-4 as for
    one direction."""
    gen = torch.Generator(device=card).manual_seed(7 * hidden + batch)
    dirs = []
    for reverse in (False, True):
        x_proj = torch.randn(60, batch, 3 * hidden, device=card,
                             generator=gen)
        w_hh = (torch.rand(3 * hidden, hidden, device=card, generator=gen)
                - 0.5) / hidden ** 0.5
        b_hh = torch.rand(3 * hidden, device=card, generator=gen) - 0.5
        outs = gru.gru_recurrence(x_proj, w_hh, b_hh, reverse)
        grad = torch.randn(outs.shape, device=card, generator=gen)
        dirs.append((x_proj, w_hh, b_hh, outs, grad))
    before = gru.BACKWARD_KERNEL.launches
    got = gru.gru_bidirectional_backward(*dirs)
    torch.cuda.synchronize()
    assert gru.BACKWARD_KERNEL.launches == before + 1
    for d, reverse, got_d in zip(dirs, (False, True), got):
        ref = gru.gru_backward_plain(*d, reverse)
        for a, b in zip(got_d, ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,h,w,c", [(2, 16, 32, 64), (2, 16, 32, 32),
                                     (2, 64, 448, 64), (2, 64, 448, 32),
                                     (2, 64, 40, 64)])
def test_conv3x3_kernel_matches_plain(card, n, h, w, c):
    """The probe's rule, max |err| / max |ref| < 5e-2; bf16 outputs of the
    same float32 sums differ by one bf16 step at most (read 3e-3). W=40 is
    not a multiple of the kernel's 64-column tile."""
    gen = torch.Generator(device=card).manual_seed(c)
    x = torch.randn(n, h, w, c, device=card, generator=gen).bfloat16()
    k = torch.randn(3, 3, c, c, device=card, generator=gen) / (3 * c ** 0.5)
    before = conv_probe.KERNEL.launches
    y = conv_probe.conv3x3_superp(x, k, 2)
    torch.cuda.synchronize()
    assert conv_probe.KERNEL.launches == before + 1
    ref = conv_probe.conv3x3_plain(x, k)
    err = ((y.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert err < 5e-2


def test_train_step_on_card_matches_cpu(card):
    """One float32 step (TF32 off) at the tiny geometry, B=2, dropout 0,
    the same weights, batch and eps on both devices: metrics at rtol 1e-4,
    BN running statistics and spectral u at atol 1e-5, Adam first moments
    (0.5 times the clipped gradient) per tensor within 1e-3 of the tensor's
    largest value, at least 1e-5 of the network's (cuDNN's and the CPU's sum
    orders differ; gradients that are zero in exact arithmetic hold rounding
    noise). The step launches the GRU forward kernel and the backward
    kernel twice each (once per BiGRU layer, both directions)."""
    cfg = get_config("v2", **{**TINY, "char_rnn_dropout": 0.0})
    g_sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    d_sd = discriminator_state_dict_from_jax(*random_discriminator_tree(1))
    vgg_sd = vgg_state_dict_from_jax(random_vgg_tree(2))
    rng = np.random.default_rng(3)
    shape = (2, cfg.patch_h, cfg.patch_w)
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                 np.float32),
             "text": rng.integers(0, cfg.vocab_size, (2, cfg.max_text_len)),
             "eps": rng.normal(0, 1, (2, 1, 1, cfg.z_ch)).astype(np.float32)}
    step = build_train_step(cfg)
    runs = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(cfg, g_sd, d_sd, device=device)
        vgg = VGG16Features().to(device)
        vgg.load_state_dict(vgg_sd)
        before = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        state, metrics = step(state, vgg, batch_to_device(batch, device),
                              torch.Generator(device=device).manual_seed(0),
                              1e-3)
        if device == "cuda":
            torch.cuda.synchronize()
            assert (gru.KERNEL.launches - before[0],
                    gru.BACKWARD_KERNEL.launches - before[1]) == (2, 2)
        runs[device] = (
            {k: float(v) for k, v in metrics.items()},
            {k: v.cpu() for k, v in
             {**state.generator.state_dict(),
              **state.discriminator.state_dict()}.items()
             if "running_" in k or "weight_u" in k},
            {n: state.opt_g.state[p]["exp_avg"].cpu()
             for n, p in state.generator.named_parameters()})
    (m_gpu, buf_gpu, mom_gpu), (m_cpu, buf_cpu, mom_cpu) = (
        runs["cuda"], runs["cpu"])
    for key in m_cpu:
        assert m_gpu[key] == pytest.approx(m_cpu[key], rel=1e-4, abs=1e-6)
    for key in buf_cpu:
        torch.testing.assert_close(buf_gpu[key], buf_cpu[key], atol=1e-5,
                                   rtol=1e-4)
    floor = 1e-5 * max(float(v.abs().max()) for v in mom_cpu.values())
    for key in mom_cpu:
        scale = float(mom_cpu[key].abs().max())
        torch.testing.assert_close(mom_gpu[key], mom_cpu[key], rtol=0,
                                   atol=max(1e-3 * scale, floor))
