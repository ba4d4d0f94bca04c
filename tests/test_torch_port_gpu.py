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
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.utils.port_jax import (
    random_jax_tree, state_dict_from_jax)

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


@pytest.mark.parametrize("hidden", [12, 1024])
def test_kernel_refuses_unsupported_hidden(card, hidden):
    """H must split over the 8 CTAs of a cluster, and an eighth of W_hh
    must fit one SM's shared memory."""
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
    assert gru.KERNEL.launches - before == 4 * 3       # 3 chunks
    ref = InferenceEngine(cfg, sd, batch_size=2, device="cpu").generate(
        ru, mask, texts)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
