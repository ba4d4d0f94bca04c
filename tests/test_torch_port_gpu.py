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
from vae_gan_mark_tpu_torch.utils.profiling import recording

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
    ``multi_step=1``, with cuDNN's deterministic algorithms, in bfloat16,
    the precision v2 trains in: parameters, buffers, both Adams and the
    records equal bit for bit; 2 + 2 GRU launches and 4 + 4 resize launches
    per train step and 2 and 4 per val batch, replays included."""
    import json

    from vae_gan_mark_tpu_torch.ops import resize

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states, records = {}, {}
        for k in (1, 4):
            trainer = trainer_on(card, tmp_path / f"k{k}", steps=8,
                                 val_batches=4, multi_step=k,
                                 compute_dtype="bfloat16")
            gru.KERNEL.launches = gru.BACKWARD_KERNEL.launches = 0
            resize.RESIZE_KERNEL.launches = 0
            resize.RESIZE_BACKWARD_KERNEL.launches = 0
            trainer.fit(2)
            torch.cuda.synchronize()
            assert (gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches) == (
                2 * (2 * 8 + 2 * 4), 2 * 2 * 8)
            assert (resize.RESIZE_KERNEL.launches,
                    resize.RESIZE_BACKWARD_KERNEL.launches) == (
                4 * (2 * 8 + 2 * 4), 4 * 2 * 8)
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


SERVED = {"v2": {}, "vanilla": {}, "oldv": {"enc_chans": (8, 16, 24)},
          "lr_sh": {}}


@pytest.mark.parametrize("variant", list(SERVED))
@pytest.mark.parametrize("batch", [1, 2])
def test_engine_replays_a_captured_forward_as_eager(card, monkeypatch,
                                                    variant, batch):
    """Four requests of one chunk, each with other patches and texts: the
    engine runs the first eagerly, captures the second and replays the
    rest (1 eager, 1 capture, 3 replayed), and each output equals a fresh
    engine's first, eager output on the same request and seed bit for bit.
    The GRU kernels' host work is prepared before the capture for v2 and
    oldv (strip-factored FiLM, gated skips); vanilla and lr_sh take the
    sbert text path (a float ``text``) and launch no GRU, so nothing is
    prepared. cuDNN keeps to deterministic algorithms here:
    at batch 1 it may pick, for vanilla's transposed convolutions, one that
    sums with atomics, and then two eager runs differ in the last bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = get_config(variant, **{**TINY, **SERVED[variant]})
    sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    rng = np.random.default_rng(batch)
    requests = [
        (rng.uniform(0, 1, (batch, 32, 64, 3)).astype(np.float32),
         (rng.uniform(0, 1, (batch, 32, 64, 1)) > 0.5).astype(np.float32),
         [f"{word} {i}" for i in range(batch)])
        for word in ("SALE", "NEW", "50% OFF", "x" * 20)]
    prepared = []
    prepare = gru.KERNEL.prepare
    monkeypatch.setattr(gru.KERNEL, "prepare", lambda rows, hidden: (
        prepared.append((rows, hidden)), prepare(rows, hidden)))
    engine = InferenceEngine(cfg, sd, batch_size=batch, seed=3, device=card)
    before = gru.KERNEL.launches
    with recording() as rec:
        outs = [engine.generate(*req) for req in requests]
    assert [s.attrs["kind"] for s in rec.spans
            if s.name == "serve.forward"] == [
        "eager", "capture", "replay", "replay"]
    assert rec.counters == {"serve.rows_requested": 4 * batch,
                            "serve.rows_computed": 4 * batch,
                            "serve.forwards_eager": 1,
                            "serve.graph_captures": 1,
                            "serve.forwards_replayed": 3}
    runs_gru = cfg.text_encoder != "sbert"
    assert gru.KERNEL.launches - before == (8 if runs_gru else 0)
    assert prepared == ([(batch, cfg.char_rnn_hidden)] if runs_gru else [])
    for req, out in zip(requests, outs):
        fresh = InferenceEngine(cfg, sd, batch_size=batch, seed=3,
                                device=card)
        assert np.array_equal(out, fresh.generate(*req))


def test_engine_refuses_a_capture_that_records_nothing(card, monkeypatch):
    """A forward that launches nothing on the capture's stream (here one
    that returns a tensor made before the capture) leaves the graph empty,
    which PyTorch only warns of: the engine raises instead of replaying
    stale outputs."""
    cfg = get_config("vanilla", **TINY)
    sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    rng = np.random.default_rng(6)
    request = (rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32),
               np.ones((1, 32, 64, 1), np.float32), ["SALE"])
    engine = InferenceEngine(cfg, sd, batch_size=1, seed=3, device=card)
    stale = torch.tensor(engine.generate(*request), device=card)
    monkeypatch.setattr(engine, "_forward", lambda batch: stale)
    with pytest.raises(RuntimeError, match="recorded nothing"):
        engine.generate(*request)


SECOND_CARD = """
import numpy as np, torch
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.utils.port_jax import (
    random_jax_tree, state_dict_from_jax)
from vae_gan_mark_tpu_torch.utils.profiling import recording
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
rng = np.random.default_rng(0)
requests = [(rng.uniform(0, 1, (2, 32, 64, 3)).astype(np.float32),
             (rng.uniform(0, 1, (2, 32, 64, 1)) > 0.5).astype(np.float32),
             [word, word + "!"]) for word in ("SALE", "NEW", "50% OFF", "X")]
for variant in ("vanilla", "v2"):
    cfg = get_config(variant, **TINY)
    sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    engine = InferenceEngine(cfg, sd, batch_size=2, seed=3, device="cuda:1")
    with recording() as rec:
        outs = [engine.generate(*req) for req in requests]
    assert rec.counters["serve.graph_captures"] == 1, rec.counters
    assert rec.counters["serve.forwards_replayed"] == 3, rec.counters
    for req, out in zip(requests, outs):
        fresh = InferenceEngine(cfg, sd, batch_size=2, seed=3,
                                device="cuda:1")
        assert np.array_equal(out, fresh.generate(*req)), variant
    assert torch.cuda.current_device() == 0
print("served on cuda:1")
"""


def test_engine_on_a_second_card_replays_there(card):
    """In a fresh process whose current device stays cuda:0, vanilla and
    v2 engines on cuda:1 capture their forward on cuda:1: the three
    replayed requests equal fresh engines' eager outputs bit for bit (a
    capture on cuda:0's stream would record none of cuda:1's launches and
    replay the capture's output for every request)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    run = subprocess.run(
        [sys.executable, "-c", f"TINY = {TINY!r}\n" + SECOND_CARD],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "served on cuda:1" in run.stdout


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
    GRU kernel launched twice a chunk and the resize kernel four times (one
    custom-op node a FiLM stage) inside the program."""
    from vae_gan_mark_tpu_torch.models import VAEGANGenerator
    from vae_gan_mark_tpu_torch.ops import resize
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
    resize_op = getattr(torch.ops, resize.NAMESPACE).resize_bilinear.default
    assert [n.target for n in art.program.graph.nodes
            if n.op == "call_function"].count(resize_op) == 4
    before = gru.KERNEL.launches, resize.RESIZE_KERNEL.launches
    got = art.generate(ru, mask, texts, seed=2)
    assert (gru.KERNEL.launches, resize.RESIZE_KERNEL.launches) == (
        before[0] + 4, before[1] + 8)               # 2 chunks
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
    both rates, cuDNN's default algorithms (with them a float32 step does
    not repeat bit for bit: the model ranks' gradients differ in
    rounding), three steps of v2 at the tiny geometry with the BiGRU's
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


# ------------------------------------------------------------------ resize
# (input shape, output (h, w), layout): every resize the port makes on the
# card at full width (v2's four FiLM stages, each also on a permuted view and
# on a channels-last one, the layout of the serving engine's batch-1 text
# map; oldv's three strips and its decoder strip), and three off its path:
# both axes up (the naive FiLM), both down, and both down on a permuted
# view.
RESIZE_CASES = (
    [((16, 512, 1, 28), (1, w), layout) for w in (56, 112, 224, 448)
     for layout in ("nchw", "permuted", "channels_last")]
    + [((16, 512, 4, 28), (4, w), "nchw") for w in (112, 224, 448)]
    + [((16, 512, 4, 28), (1, 56), "nchw"), ((2, 3, 1, 28), (8, 56), "nchw"),
       ((2, 3, 6, 10), (3, 4), "nchw"), ((2, 3, 6, 10), (3, 4), "permuted")])


def _resize_input(card, shape, layout, seed=0):
    """An NCHW tensor held in NCHW memory, as a permuted view of (N, W, H,
    C) memory, or in channels-last memory (N, H, W, C)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n, c, h, w = shape
    if layout == "permuted":
        return torch.randn(n, w, h, c, device=card,
                           generator=gen).permute(0, 3, 2, 1)
    if layout == "channels_last":
        return torch.randn(n, h, w, c, device=card,
                           generator=gen).permute(0, 3, 1, 2)
    return torch.randn(shape, device=card, generator=gen)


def _ordered_bits(t):
    bits = t.contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _upsample_backward(grad, in_shape):
    return torch.ops.aten.upsample_bilinear2d_backward(
        grad, list(grad.shape[2:]), list(in_shape), False)


@pytest.mark.parametrize("shape,out,layout", RESIZE_CASES)
def test_resize_kernel_matches_f_interpolate(card, shape, out, layout):
    """The forward kernel against ``F.interpolate`` on the card, within one
    float32 ulp of each value (the two compile PyTorch's source-index
    arithmetic and tap order separately), in the memory format
    ``F.interpolate`` gives the input, and one launch a call. The values
    come from the library on a contiguous copy: that is its NCHW kernel,
    the one the port called at batch 16; for channels-last it runs another
    kernel whose multiply-adds round otherwise, which moves outputs near
    zero by many ulps."""
    from vae_gan_mark_tpu_torch.ops import resize

    x = _resize_input(card, shape, layout)
    before = resize.RESIZE_KERNEL.launches
    got = resize.interpolate_bilinear(x, *out)
    torch.cuda.synchronize()
    assert resize.RESIZE_KERNEL.launches == before + 1
    interpolate = torch.nn.functional.interpolate
    assert got.stride() == interpolate(x, size=out, mode="bilinear",
                                       align_corners=False).stride()
    want = interpolate(x.contiguous(), size=out, mode="bilinear",
                       align_corners=False)
    assert got.shape == want.shape
    assert int((_ordered_bits(got) - _ordered_bits(want)).abs().max()) <= 1


@pytest.mark.parametrize("shape,out,layout", RESIZE_CASES)
def test_resize_gradient_matches_float64(card, shape, out, layout):
    """The input gradient through ``interpolate_bilinear`` (the gather
    kernel, one launch) against ``F.interpolate``'s in float64 on the CPU:
    within 2e-6 of the same gradient of |grad|, the float32 rounding of at
    most ~34 weighted terms."""
    from vae_gan_mark_tpu_torch.ops import resize

    x = _resize_input(card, shape, layout).requires_grad_()
    y = resize.interpolate_bilinear(x, *out)
    grad = torch.randn(y.shape, device=card,
                       generator=torch.Generator(device=card).manual_seed(1))
    before = resize.RESIZE_BACKWARD_KERNEL.launches
    y.backward(grad)
    torch.cuda.synchronize()
    assert resize.RESIZE_BACKWARD_KERNEL.launches == before + 1
    grad64 = grad.double().cpu()
    want = _upsample_backward(grad64, shape)
    scale = _upsample_backward(grad64.abs(), shape)
    err = (x.grad.double().cpu() - want).abs()
    assert bool((err <= 2e-6 * scale).all()), float((err / scale).max())


@pytest.mark.parametrize("case", [9, 11, 14, 15])
def test_resize_backward_repeats_bit_for_bit(card, case):
    """Two float32 backward runs on one gradient give equal input gradients
    bit for bit: the gather adds in a fixed order, with no atomics."""
    from vae_gan_mark_tpu_torch.ops import resize

    shape, out, layout = RESIZE_CASES[case]
    grads = []
    for _ in range(2):
        x = _resize_input(card, shape, layout).requires_grad_()
        y = resize.interpolate_bilinear(x, *out)
        y.backward(torch.randn(
            y.shape, device=card,
            generator=torch.Generator(device=card).manual_seed(2)))
        grads.append(x.grad)
    assert torch.equal(*grads)


def test_resize_captured_in_a_graph_replays_as_eager(card):
    """A resize and its gradient captured in one CUDA graph: the capture
    records one launch of each kernel, and replays on new inputs equal
    eager calls bit for bit and add their launches to the counts."""
    from vae_gan_mark_tpu_torch.ops import resize
    from vae_gan_mark_tpu_torch.train.graphs import CapturedStep

    def inputs(seed):
        gen = torch.Generator(device=card).manual_seed(seed)
        return {"ru": torch.randn(16, 28, 512, device=card, generator=gen),
                "en": torch.randn(16, 512, 1, 448, device=card,
                                  generator=gen)}

    def fwd_bwd(batch, generator=None, kl=None):
        x = batch["ru"].transpose(1, 2)[:, :, None, :].detach()
        x.requires_grad_()
        y = resize.interpolate_bilinear(x, 1, 448)
        return [y, *torch.autograd.grad(y, [x], batch["en"])]

    warm = inputs(1)
    fwd_bwd(warm)
    graph = CapturedStep(fwd_bwd, warm)
    assert graph.launches == {resize.RESIZE_KERNEL: 1,
                              resize.RESIZE_BACKWARD_KERNEL: 1}
    for seed in (2, 3):
        batch = inputs(seed)
        before = (resize.RESIZE_KERNEL.launches,
                  resize.RESIZE_BACKWARD_KERNEL.launches)
        got = [t.clone() for t in graph.replay(batch, 0, 0.0)]
        assert (resize.RESIZE_KERNEL.launches,
                resize.RESIZE_BACKWARD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
        for a, b in zip(got, fwd_bwd(batch)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("variant,overrides", [
    ("v2", {}), ("v2", {"fast_film": False}),
    ("oldv", {"enc_chans": (8, 16, 24)})])
def test_resize_launches_per_train_step(card, monkeypatch, variant,
                                        overrides):
    """A train step launches the resize kernel 4 times and its backward 4
    times (v2: one a FiLM stage; oldv: three FiLM strips and the decoder's
    strip; the naive FiLM path too), an eval step 4 forward launches, and
    no CUDA tensor reaches ``F.interpolate``."""
    from vae_gan_mark_tpu_torch.ops import resize
    from vae_gan_mark_tpu_torch.train import build_eval_step

    cfg = get_config(variant, **{**TINY, **overrides})
    state = create_train_state(
        cfg, state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg),
        discriminator_state_dict_from_jax(*random_discriminator_tree(1)),
        device=card)
    vgg = VGG16Features().to(card)
    rng = np.random.default_rng(6)
    shape = (4, cfg.patch_h, cfg.patch_w)
    batch = batch_to_device(
        {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
         "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
         "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(np.float32),
         "text": rng.integers(1, cfg.vocab_size, (4, cfg.max_text_len))},
        card)
    step = build_train_step(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    state, _ = step(state, vgg, batch, gen, 1e-3)    # device constants
    interpolate = torch.nn.functional.interpolate

    def cpu_only(x, *args, **kwargs):
        assert x.device.type == "cpu", "a CUDA tensor reached F.interpolate"
        return interpolate(x, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "interpolate", cpu_only)
    counts = []
    for run in (lambda: step(state, vgg, batch, gen, 1e-3),
                lambda: build_eval_step(cfg)(state, vgg, batch, gen, 1e-3)):
        before = (resize.RESIZE_KERNEL.launches,
                  resize.RESIZE_BACKWARD_KERNEL.launches)
        run()
        torch.cuda.synchronize()
        counts.append((resize.RESIZE_KERNEL.launches - before[0],
                       resize.RESIZE_BACKWARD_KERNEL.launches - before[1]))
    assert counts == [(4, 4), (4, 0)]


@pytest.mark.parametrize("variant,overrides", [
    ("v2", {}), ("oldv", {"enc_chans": (8, 16, 24)})])
def test_float32_train_step_on_card_repeats_bit_for_bit(card, monkeypatch,
                                                        variant, overrides):
    """One float32 train step (TF32 off) run twice from the same weights,
    batch and generator seed, with cuDNN's deterministic algorithms: every
    parameter, buffer and Adam moment equal bit for bit. (PyTorch's
    bilinear upsampling backward, which adds with float32 atomics, made
    this fail before the port took its own resize kernels.)"""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = get_config(variant, **{**TINY, **overrides})
    g_sd = state_dict_from_jax(*random_jax_tree(cfg, seed=0), cfg)
    d_sd = discriminator_state_dict_from_jax(*random_discriminator_tree(1))
    rng = np.random.default_rng(7)
    shape = (4, cfg.patch_h, cfg.patch_w)
    batch = {"ru": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "en": rng.uniform(0, 1, shape + (3,)).astype(np.float32),
             "mask": (rng.uniform(0, 1, shape + (1,)) > 0.5).astype(
                 np.float32),
             "text": rng.integers(1, cfg.vocab_size, (4, cfg.max_text_len))}
    vgg = VGG16Features().to(card)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, g_sd, d_sd, device=card)
        state, _ = build_train_step(cfg)(
            state, vgg, batch_to_device(batch, card),
            torch.Generator(device=card).manual_seed(0), 1e-3)
        tensors = {f"G.{k}": v for k, v in
                   state.generator.state_dict().items()}
        tensors.update({f"D.{k}": v for k, v in
                        state.discriminator.state_dict().items()})
        for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
            for i, entry in enumerate(opt.state.values()):
                tensors.update({f"{name}{i}.{n}": v
                                for n, v in entry.items()})
        runs.append(tensors)
    assert runs[0].keys() == runs[1].keys()
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key


def test_resize_custom_ops_on_card(card):
    """``torch.library.opcheck`` (schema, fake implementation, autograd
    registration) on both resize ops with CUDA tensors in three layouts."""
    from vae_gan_mark_tpu_torch.ops import resize

    for layout in ("nchw", "permuted", "channels_last"):
        x = _resize_input(card, (2, 8, 4, 12), layout).requires_grad_()
        torch.library.opcheck(resize.resize_bilinear_op, (x, 3, 20))
    torch.library.opcheck(resize.resize_bilinear_backward_op,
                          (torch.randn(2, 8, 1, 48, device=card), 1, 12))
