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


def trainer_on(card, workdir, steps=3, val_batches=1, multi_step=1,
               **overrides):
    """A tiny v2 Trainer on the card over device-resident synthetic data:
    ``steps`` train batches and ``val_batches`` val batches of 4 an
    epoch."""
    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    from vae_gan_mark_tpu_torch.train.loop import Trainer

    cfg = get_config("v2", batch_size=4, **{**TINY, **overrides})
    train = DeviceResidentSynthetic(SyntheticPatchDataset(cfg, 4 * steps), 4,
                                    steps, device=card)
    val = DeviceResidentSynthetic(
        SyntheticPatchDataset(cfg, 4 * val_batches, seed=1), 4, val_batches,
        advance_per_epoch=False, device=card)
    return Trainer(cfg, train, val, str(workdir), seed=0, device=card,
                   multi_step=multi_step)


def test_trainer_epoch_on_card_launches_the_gru_kernels(card, tmp_path):
    """One epoch: 2 forward + 2 backward launches per train step (one per
    BiGRU layer for both directions) and 2 forward per val batch."""
    trainer = trainer_on(card, tmp_path)
    gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
    trainer.fit(1)
    torch.cuda.synchronize()
    assert (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches) == (
        2 * 3 + 2 * 1, 2 * 3)
    assert trainer.state.step == 3
    assert (tmp_path / "last_checkpoint" / "state.pt").is_file()
    assert (tmp_path / "best_model" / "state.pt").is_file()


def test_checkpoint_round_trip_on_card(card, tmp_path):
    from vae_gan_mark_tpu_torch.train.checkpoint import restore_checkpoint

    trainer = trainer_on(card, tmp_path)
    trainer.fit(1)
    fresh = trainer_on(card, tmp_path / "other")
    meta = restore_checkpoint(str(tmp_path), "last_checkpoint", fresh.state)
    assert meta["epoch"] == 0 and fresh.state.step == trainer.state.step
    for a, b in ((fresh.state.generator, trainer.state.generator),
                 (fresh.state.discriminator, trainer.state.discriminator)):
        for (key, x), y in zip(a.state_dict().items(),
                               b.state_dict().values()):
            assert x.device.type == "cuda" and torch.equal(x, y), key
    for a, b in ((fresh.state.opt_g, trainer.state.opt_g),
                 (fresh.state.opt_d, trainer.state.opt_d)):
        for pa, pb in zip(a.state.values(), b.state.values()):
            for key in pb:
                assert pa[key].device == pb[key].device, key
                assert torch.equal(pa[key], pb[key]), key


def test_from_checkpoint_on_card_matches_the_trained_generator(card,
                                                                tmp_path):
    trainer = trainer_on(card, tmp_path)
    trainer.fit(1)
    cfg = trainer.cfg
    engine = InferenceEngine.from_checkpoint(cfg, str(tmp_path),
                                             "last_checkpoint", batch_size=4,
                                             seed=1, device=card)
    reference = InferenceEngine(cfg, trainer.state.generator.state_dict(),
                                batch_size=4, seed=1, device=card)
    rng = np.random.default_rng(0)
    ru = rng.uniform(0, 1, (5, 32, 64, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (5, 32, 64, 1)) > 0.5).astype(np.float32)
    texts = ["a", "bc", "def", "", "SALE"]
    gru.KERNEL.launches = 0
    out = engine.generate(ru, mask, texts)
    torch.cuda.synchronize()
    assert gru.KERNEL.launches == 2 * 2              # 2 chunks of 4
    assert np.array_equal(out, reference.generate(ru, mask, texts))


def test_gru_kernels_captured_in_a_graph_replay_as_eager(card):
    """Both BiGRU kernels (a forward and a backward launch, 8-CTA clusters
    launched with ``cudaLaunchKernelEx``) captured in one CUDA graph: a
    replay on new inputs equals eager launches bit for bit, and the
    capture recorded one launch of each."""
    from vae_gan_mark_tpu_torch.train.graphs import CapturedStep

    def inputs(seed):
        gen = torch.Generator(device=card).manual_seed(seed)
        return {"ru": torch.randn(60, 16, 3 * 256, device=card,
                                  generator=gen),
                "en": torch.randn(60, 16, 3 * 256, device=card,
                                  generator=gen),
                "mask": torch.randn(60, 16, 2 * 256, device=card,
                                    generator=gen)}

    gen = torch.Generator(device=card).manual_seed(9)
    weights = [((torch.rand(3 * 256, 256, device=card, generator=gen) - 0.5)
                / 16).requires_grad_() for _ in range(2)]
    biases = [(torch.rand(768, device=card, generator=gen) - 0.5
               ).requires_grad_() for _ in range(2)]

    def fwd_bwd(batch, generator=None, kl=None):
        x_f = batch["ru"].clone().requires_grad_()
        x_b = batch["en"].clone().requires_grad_()
        outs = gru.bigru_recurrence_grad(x_f, weights[0], biases[0],
                                         x_b, weights[1], biases[1])
        grads = torch.autograd.grad(
            outs, [x_f, x_b, *weights, *biases],
            [batch["mask"][..., :256].contiguous(),
             batch["mask"][..., 256:].contiguous()])
        return [*outs, *grads]

    warm = inputs(1)
    fwd_bwd(warm)
    gru.KERNEL.prepare(16, 256)
    gru.BACKWARD_KERNEL.prepare(16, 256)
    graph = CapturedStep(fwd_bwd, warm)
    assert graph.launches == {gru.KERNEL: 1, gru.BACKWARD_KERNEL: 1}
    for seed in (2, 3):
        batch = inputs(seed)
        before = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        got = [t.clone() for t in graph.replay(batch, 0, 0.0)]
        assert (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
        for a, b in zip(got, fwd_bwd(batch)):
            assert torch.equal(a, b)


def test_reseeded_graph_generator_draws_like_a_fresh_one(card):
    """A replay after ``manual_seed(s)`` draws what an eager run draws from
    a fresh generator seeded with s: the reparameterisation noise
    (``randn``) and a dropout mask (``bernoulli_``)."""
    from vae_gan_mark_tpu_torch.ops.rnn import dropout_mask
    from vae_gan_mark_tpu_torch.train.graphs import CapturedStep

    def draws(batch, generator, kl=None):
        noise = torch.randn(batch["ru"].shape, generator=generator,
                            device=card)
        return noise, dropout_mask(batch["ru"], 0.1, generator)

    batch = {"ru": torch.zeros(8, 1, 1, 128, device=card)}
    draws(batch, torch.Generator(device=card).manual_seed(0))   # warm-up
    graph = CapturedStep(draws, batch)
    for seed in (11, 12, 11):
        got = [t.clone() for t in graph.replay(batch, seed, 0.0)]
        ref = draws(batch, torch.Generator(device=card).manual_seed(seed))
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_trainer_multi_step_on_card_equals_single_steps(card, tmp_path):
    """``multi_step=4`` over 2 epochs of 8 train batches and 4 val batches
    (the first group of each kind eager, the rest graph replays) against
    ``multi_step=1``, with cuDNN's deterministic algorithms: parameters,
    buffers, both Adams and the records equal bit for bit; 2 + 2 GRU
    launches per train step and 2 per val batch, replays included.

    In bfloat16: there the FiLM text map's gradient reaches the bilinear
    upsample's backward as bf16 values, whose float32 atomic sums are exact
    in any order. In float32 they are not (``chip_smoke.py`` phase 9
    prints the spread of that backward run twice), so float32 steps on the
    card are not reproducible bit for bit even eagerly."""
    import json

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states, records = {}, {}
        for k in (1, 4):
            trainer = trainer_on(card, tmp_path / f"k{k}", steps=8,
                                 val_batches=4, multi_step=k,
                                 compute_dtype="bfloat16")
            gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
            trainer.fit(2)
            torch.cuda.synchronize()
            assert (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches) == (
                2 * (2 * 8 + 2 * 4), 2 * 2 * 8)
            state = trainer.state
            states[k] = {**{f"G.{n}": v for n, v in
                            state.generator.state_dict().items()},
                         **{f"D.{n}": v for n, v in
                            state.discriminator.state_dict().items()}}
            for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
                for i, entry in enumerate(opt.state.values()):
                    states[k].update({f"{name}{i}.{n}": v
                                      for n, v in entry.items()})
            with open(tmp_path / f"k{k}" / "v2.metrics.jsonl") as f:
                records[k] = [{n: v for n, v in json.loads(line).items()
                               if n not in ("time", "train/images_per_sec")}
                              for line in f]
        assert states[1].keys() == states[4].keys()
        for key in states[1]:
            assert torch.equal(states[1][key], states[4][key]), key
        assert records[1] == records[4]
    finally:
        torch.backends.cudnn.deterministic = saved


def test_oldv_generator_on_card_launches_the_gru_twice(card):
    """The oldv generator (3 levels, gated skips, strip-factored FiLM over
    a height-4 text map) on the card: one GRU forward launch per BiGRU
    layer, and the CPU's output within 1e-4 (float32, TF32 off)."""
    from vae_gan_mark_tpu_torch.models import VAEGANGenerator

    cfg = get_config("oldv", **{**TINY, "enc_chans": (8, 16, 24)})
    sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    rng = np.random.default_rng(4)
    args = (rng.uniform(0, 1, (3, 32, 64, 3)).astype(np.float32),
            (rng.uniform(0, 1, (3, 32, 64, 1)) > 0.5).astype(np.float32),
            rng.integers(1, cfg.vocab_size, (3, cfg.max_text_len)),
            rng.normal(0, 1, (3, 1, 1, cfg.z_ch)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        model = VAEGANGenerator(cfg)
        model.load_state_dict(sd)
        model.to(device).eval()
        before = gru.KERNEL.launches
        with torch.no_grad():
            outs[device] = [t.cpu() for t in model(
                *(torch.from_numpy(a).to(device) for a in args[:2]),
                torch.from_numpy(args[2]).to(device),
                eps=torch.from_numpy(args[3]).to(device))]
        if device == "cuda":
            assert gru.KERNEL.launches - before == 2
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_vanilla_serving_on_card_matches_cpu(card):
    """vanilla through ``InferenceEngine`` on the card and on the CPU, the
    same weights, noise and hash-embedded texts: within 1e-4 (float32, TF32
    off), and no GRU launch (the plain generator has no GRU)."""
    cfg = get_config("vanilla", **TINY)
    sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    rng = np.random.default_rng(5)
    ru = rng.uniform(0, 1, (5, 32, 64, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (5, 32, 64, 1)) > 0.5).astype(np.float32)
    texts = ["SALE", "", "50% OFF", "NEW", "x" * 70]
    before = gru.KERNEL.launches
    got = InferenceEngine(cfg, sd, batch_size=4, device=card).generate(
        ru, mask, texts)
    assert gru.KERNEL.launches == before
    ref = InferenceEngine(cfg, sd, batch_size=4, device="cpu").generate(
        ru, mask, texts)
    assert got.shape == (5, 32, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["v2", "vanilla"])
def test_conditional_disc_step_on_card_matches_cpu(card, variant):
    """One float32 step with the conditional D head (``cond_embed`` for v2,
    ``cond_dense`` for vanilla) on the card and on the CPU: the metrics at
    rtol 1e-4, the head's Adam first moments within 1e-3 of their largest
    value; v2 launches each GRU kernel twice, vanilla neither."""
    from vae_gan_mark_tpu_torch.train.state import init_state_dicts

    cfg = get_config(variant, **{**TINY, "char_rnn_dropout": 0.0,
                                 "conditional_disc": True})
    g_sd, d_sd = init_state_dicts(cfg, seed=2)
    assert any(k.startswith("cond_proj") for k in d_sd)
    vgg_sd = vgg_state_dict_from_jax(random_vgg_tree(2))
    rng = np.random.default_rng(6)
    shape = (2, cfg.patch_h, cfg.patch_w)
    text = (rng.normal(0, 1, (2, cfg.sbert_dim)).astype(np.float32)
            if variant == "vanilla"
            else rng.integers(0, cfg.vocab_size, (2, cfg.max_text_len)))
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                 np.float32),
             "text": text,
             "eps": rng.normal(0, 1, (2, 1, 1, cfg.z_ch)).astype(np.float32)}
    runs = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(cfg, g_sd, d_sd, device=device)
        vgg = VGG16Features().to(device)
        vgg.load_state_dict(vgg_sd)
        before = (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches)
        state, metrics = build_train_step(cfg)(
            state, vgg, batch_to_device(batch, device),
            torch.Generator(device=device).manual_seed(0), 1e-3)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = (gru.KERNEL.launches - before[0],
                        gru.BACKWARD_KERNEL.launches - before[1])
            assert launches == ((2, 2) if variant == "v2" else (0, 0))
        runs[device] = ({k: float(v) for k, v in metrics.items()},
                        {n: state.opt_d.state[p]["exp_avg"].cpu()
                         for n, p in state.discriminator.named_parameters()
                         if n.startswith("cond")})
    (m_gpu, head_gpu), (m_cpu, head_cpu) = runs["cuda"], runs["cpu"]
    for key in m_cpu:
        assert m_gpu[key] == pytest.approx(m_cpu[key], rel=1e-4, abs=1e-6)
    for key in head_cpu:
        torch.testing.assert_close(
            head_gpu[key], head_cpu[key], rtol=0,
            atol=1e-3 * float(head_cpu[key].abs().max()))


def _gru_op_inputs(card, hidden=16, batch=4, length=12, grad=True):
    gen = torch.Generator(device=card).manual_seed(hidden + batch)
    x = torch.randn(length, batch, 3 * hidden, device=card, generator=gen)
    w = (torch.rand(3 * hidden, hidden, device=card, generator=gen)
         - 0.5) / hidden ** 0.5
    b = torch.rand(3 * hidden, device=card, generator=gen) - 0.5
    return [t.requires_grad_(grad) for t in (x, w, b)]


@pytest.mark.parametrize("hidden", [16, 256])
def test_gru_custom_ops_on_card(card, hidden):
    """The four GRU ops on CUDA tensors: ``torch.library.opcheck`` (schema,
    fake implementation, autograd registration) and each against its plain
    version (forward atol 1e-5 rtol 1e-4, gradients atol 1e-4 rtol 1e-4, as
    the kernels' own card tests), with one kernel launch a call."""
    fwd, bwd = (_gru_op_inputs(card, hidden, batch=b) for b in (4, 4))
    bwd = [bwd[0].detach().roll(1, 0).requires_grad_(True)] + bwd[1:]
    torch.library.opcheck(gru.gru_forward_op, (*fwd, True))
    torch.library.opcheck(gru.bigru_forward_op, (*fwd, *bwd))
    before = gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches
    outs = gru.bigru_forward_op(*fwd, *bwd)
    grads = [torch.randn_like(o) for o in outs]
    torch.autograd.backward(outs, grads)
    torch.cuda.synchronize()
    assert (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [gru.gru_recurrence_plain(*[t.detach() for t in d], rev)
             for d, rev in ((fwd, False), (bwd, True))]
    for got, ref in zip(outs, plain):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)
    for d, g, o, rev in zip((fwd, bwd), grads, outs, (False, True)):
        ref = gru.gru_backward_plain(*[t.detach() for t in d], o.detach(), g,
                                     rev)
        for t, r in zip(d, ref):
            torch.testing.assert_close(t.grad, r, atol=1e-4, rtol=1e-4)
    detached = [t.detach() for t in fwd]
    saved = gru.gru_forward_op(*detached, False)
    back = gru.bigru_backward_op(*detached, saved, torch.ones_like(saved),
                                 *detached, saved, torch.ones_like(saved))
    torch.library.opcheck(gru.bigru_backward_op,
                          (*detached, saved, torch.ones_like(saved),
                           *detached, saved, torch.ones_like(saved)))
    assert len(back) == 6


def test_export_round_trip_on_card(card, tmp_path):
    """The tiny v2 generator exported on the card and served from its
    artifact against ``InferenceEngine`` on the card (atol 1e-5: one
    program, the same kernels; cuDNN may pick other algorithms), with the
    GRU kernel launched twice a chunk inside the program."""
    from vae_gan_mark_tpu_torch.models import VAEGANGenerator
    from vae_gan_mark_tpu_torch.serve.export import (
        ExportedGenerator, export_generator)

    cfg = get_config("v2", **TINY)
    params, stats = random_jax_tree(cfg, 0)
    generator = VAEGANGenerator(cfg)
    generator.load_state_dict(state_dict_from_jax(params, stats, cfg))
    export_generator(cfg, generator, str(tmp_path / "art"), batch_size=4)
    art = ExportedGenerator.load(str(tmp_path / "art"))
    assert art.device.type == "cuda"
    rng = np.random.default_rng(0)
    ru = rng.uniform(0, 1, (6, 32, 64, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (6, 32, 64, 1)).astype(np.float32)
    texts = [f"T{i}" for i in range(6)]
    before = gru.KERNEL.launches
    got = art.generate(ru, mask, texts, seed=2)
    assert gru.KERNEL.launches == before + 4        # 2 chunks
    want = InferenceEngine(cfg, generator, batch_size=4, seed=2,
                           device=card).generate(ru, mask, texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def write_disk_dataset(root, n_images=2, quads=3):
    """A small on-disk dataset in the reference's layout, from seed 0."""
    import json
    import os
    from PIL import Image

    rng = np.random.default_rng(0)
    dirs = {k: os.path.join(root, k) for k in ("json", "ru", "en", "mask")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n_images):
        base = f"img{i:03d}"
        for kind, shape in (("ru", (240, 320, 3)), ("en", (240, 320, 3)),
                            ("mask", (240, 320))):
            name = f"{base}_en.png" if kind == "en" else f"{base}_ru.png"
            Image.fromarray(rng.integers(0, 255, shape, np.uint8)).save(
                os.path.join(dirs[kind], name))
        anns = [{"bbox_ru": [[20 + 9 * j, 30], [130, 33 + j], [128, 80],
                             [18, 76]],
                 "bbox_en": [[22, 31], [126, 30], [127, 78 - j], [20, 77]],
                 "text": f"text {i}-{j}"} for j in range(quads)]
        with open(os.path.join(dirs["json"], f"{base}.json"), "w") as f:
            json.dump(anns, f)
    return dirs


def test_device_loader_on_card_matches_cpu(card, tmp_path):
    """``DeviceWarpLoader`` warping on the card (its own stream) against
    the same loader on the CPU: atol 1e-5 (float32 homography solves and
    taps on two devices), the texts equal."""
    from vae_gan_mark_tpu_torch.data.device_pipeline import DeviceWarpLoader
    from vae_gan_mark_tpu_torch.data.index import build_index

    dirs = write_disk_dataset(str(tmp_path))
    samples = build_index(dirs["json"], dirs["ru"], dirs["en"], dirs["mask"])
    cfg = get_config("v2", **TINY)
    got = {dev: list(DeviceWarpLoader(
        cfg, samples, range(len(samples)), batch_size=4, drop_last=False,
        seed=1, num_workers=2, device=dev)(0)) for dev in ("cuda", "cpu")}
    assert len(got["cuda"]) == len(got["cpu"]) == 2
    for g, c in zip(got["cuda"], got["cpu"]):
        assert g["raw_text"] == c["raw_text"]
        np.testing.assert_array_equal(g["text"], c["text"])
        for key in ("ru", "en", "mask"):
            assert g[key].is_cuda
            torch.testing.assert_close(g[key].cpu(), c[key], rtol=0,
                                       atol=1e-5)


def run_tp_workers(tmp_path, setup, world, tp):
    """``world`` processes of ``tests/torch_port_tp_worker.py`` on the card
    over gloo, model_parallel ``tp``, running ``setup``'s jobs; their
    results in rank order."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    torch.save(setup, tmp_path / "setup.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(root)
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_port_tp_worker.py"),
         str(tmp_path / "setup.pt"), str(r), str(world), str(tp), str(port),
         str(tmp_path), "cuda"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_model_axis_gather_over_gloo_on_cuda_tensors(card, tmp_path):
    """Two processes on the card over gloo (model_parallel 2): the gather
    of a CUDA block gives the whole tensor forward and this rank's slice of
    the cotangent backward (``tests/torch_port_tp_worker.py``'s gather
    job)."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.normal(0, 1, (6, 8)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, (6, 8)).astype(np.float32))
    ranks = run_tp_workers(tmp_path, dict(jobs={"gather": dict(
        kind="gather", full=full, dim=1, cotangent=cot)}), 2, 2)
    for r, got in enumerate(ranks):
        assert got["gather"]["device"].startswith("cuda")
        assert torch.equal(got["gather"]["whole"], full)
        assert torch.equal(got["gather"]["grad"], cot[:, 4 * r:4 * (r + 1)])


def test_model_axis_whole_leaves_stay_equal_on_card(card, tmp_path):
    """Four processes on the card over gloo, data 2 x model 2, float32,
    both rates, cuDNN's default algorithms (the bilinear upsampling's
    float32 backward adds with atomics: the model ranks' gradients differ
    in rounding), three steps of v2 at the tiny geometry with the BiGRU's
    weights, FiLM's predictor and the widest convs partitioned
    (``kernel_min_ch`` 64): the model ranks of each data index still hold
    G and D equal bit for bit, the blocks moved, and every process
    launched the GRU kernels. Nothing averaged only over the data group
    would keep them equal."""
    from vae_gan_mark_tpu_torch.train.state import (
        init_state_dicts, vgg_state_dict)

    overrides = dict(TINY, enc_chans=(8, 16, 24, 64), bottleneck_ch=64,
                     char_rnn_hidden=32)
    cfg = get_config("v2", **overrides)
    g_sd, d_sd = init_state_dicts(cfg, 0)
    rng = np.random.default_rng(5)
    shape = (4, cfg.patch_h, cfg.patch_w)
    batches = [{"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
                "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
                "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                    np.float32),
                "text": rng.integers(0, cfg.vocab_size,
                                     (4, cfg.max_text_len))}
               for _ in range(3)]
    ranks = run_tp_workers(tmp_path, dict(
        g=g_sd, d=d_sd, vgg=vgg_state_dict(),
        jobs={"train": dict(kind="train", overrides=overrides,
                            batches=batches, kl_weight=1e-3,
                            kernel_min_ch=64)}), 4, 2)
    for r, got in enumerate(ranks):
        first = ranks[r - r % 2]["train"]
        for net in ("g", "d"):
            for key, value in got["train"][net].items():
                assert torch.equal(value, first[net][key]), (r, net, key)
        assert len(got["train"]["blocks"]) == 23
        for key in got["train"]["blocks"]:
            assert not torch.equal(got["train"]["g"][key], g_sd[key]), key
        assert got["train"]["gru_launches"] == (6, 6)
