"""The port's ``InferenceEngine`` on the CPU: fixed-size chunks with a padded
tail, per-chunk noise from the seed, determinism, the full-image render
against the JAX package's warp functions, and no silent CPU run when a card
is asked for.

Chunked and padded requests must give exactly the generator's output for the
same noise (the batch rows are independent in eval mode): compared with
rtol 1e-5, atol 1e-6 since a padded batch may take another conv algorithm.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gan_mark_tpu.ops import warp as jax_warp
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.utils.profiling import recording
from vae_gan_mark_tpu_torch.utils.seeds import derive_seed

from torch_port_common import TINY, Pair

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pair():
    return Pair("v2", seed=0, **TINY)


def requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ru = rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 1)).astype(
        np.float32)
    return ru, mask, [f"text {i}" for i in range(n)]


def direct(engine, ru, mask, texts, start):
    """The generator on one padded chunk with the engine's noise."""
    n, bs = ru.shape[0], engine.batch_size
    pad = lambda a: np.concatenate(
        [a, np.zeros((bs - n,) + a.shape[1:], a.dtype)])
    tokens = engine.tokenizer.encode(list(texts) + [""] * (bs - n))
    with torch.no_grad():
        recon, _, _ = engine.model(torch.from_numpy(pad(ru)),
                                   torch.from_numpy(pad(mask)),
                                   torch.from_numpy(tokens.astype(np.int64)),
                                   eps=engine.noise(start))
    return recon[:n].numpy()


def test_generate_partial_batch(pair):
    engine = InferenceEngine(pair.cfg, pair.state_dict, batch_size=4,
                             device="cpu")
    ru, mask, texts = requests(pair.cfg, 3, 1)
    out = engine.generate(ru, mask, texts)
    assert out.shape == (3, pair.cfg.patch_h, pair.cfg.patch_w, 3)
    assert out.dtype == np.float32 and np.all(np.isfinite(out))
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, direct(engine, ru, mask, texts, 0),
                               RTOL, ATOL)


def test_generate_chunks_large_requests(pair):
    engine = InferenceEngine(pair.cfg, pair.port, batch_size=2, device="cpu")
    ru, mask, texts = requests(pair.cfg, 5, 2)
    out = engine.generate(ru, mask, texts)
    assert out.shape == (5, pair.cfg.patch_h, pair.cfg.patch_w, 3)
    for start in range(0, 5, 2):
        end = min(start + 2, 5)
        np.testing.assert_allclose(
            out[start:end],
            direct(engine, ru[start:end], mask[start:end], texts[start:end],
                   start), RTOL, ATOL)


def test_generate_is_deterministic_for_a_seed(pair):
    ru, mask, texts = requests(pair.cfg, 3, 3)
    a = InferenceEngine(pair.cfg, pair.state_dict, batch_size=2, seed=7,
                        device="cpu").generate(ru, mask, texts)
    b = InferenceEngine(pair.cfg, pair.state_dict, batch_size=2, seed=7,
                        device="cpu").generate(ru, mask, texts)
    c = InferenceEngine(pair.cfg, pair.state_dict, batch_size=2, seed=8,
                        device="cpu").generate(ru, mask, texts)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_cpu_engine_never_captures_a_graph(pair):
    """On the CPU every chunk's forward runs eagerly: a request of 3 chunks
    counts 3 eager forwards, no capture and no replay, and each
    ``serve.forward`` span is of kind ``eager``."""
    engine = InferenceEngine(pair.cfg, pair.state_dict, batch_size=2,
                             device="cpu")
    ru, mask, texts = requests(pair.cfg, 5, 4)
    with recording() as rec:
        engine.generate(ru, mask, texts)
    assert rec.counters["serve.forwards_eager"] == 3
    assert "serve.graph_captures" not in rec.counters
    assert "serve.forwards_replayed" not in rec.counters
    assert [s.attrs for s in rec.spans if s.name == "serve.forward"] == [
        {"kind": "eager"}] * 3


def test_noise_differs_per_chunk_and_seed():
    assert len({derive_seed(s, start) for s in range(3)
                for start in (0, 16, 32)}) == 9


@pytest.mark.parametrize("uint8", [False, True])
def test_render_matches_jax_warp(pair, uint8):
    cfg = pair.cfg
    engine = InferenceEngine(cfg, pair.state_dict, batch_size=1, seed=3,
                             device="cpu")
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (90, 140, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (90, 140)) > 0.5).astype(np.float32)
    if uint8:
        img = (img * 255).astype(np.uint8)
        mask = (mask * 255).astype(np.uint8)
    quad = np.array([[20.3, 15.2], [110.4, 18.1], [108.2, 60.3],
                     [18.1, 57.4]], np.float32)
    out = engine.render(img, mask, quad, "HELLO")

    # The same path with the JAX package's warps around the port's generator.
    img_f = img.astype(np.float32) / 255.0 if uint8 else img
    msk_f = (mask.astype(np.float32) / 255.0 if uint8 else mask)[..., None]
    ru = jax_warp.perspective_crop_batch(jnp.asarray(img_f)[None],
                                         jnp.asarray(quad)[None],
                                         cfg.patch_h, cfg.patch_w)
    mk = jax_warp.perspective_crop_batch(jnp.asarray(msk_f)[None],
                                         jnp.asarray(quad)[None],
                                         cfg.patch_h, cfg.patch_w)
    patch = engine.generate(np.asarray(ru), np.asarray(mk), ["HELLO"])[0]
    ref = np.asarray(jax_warp.perspective_unwarp(
        jnp.asarray(patch), jnp.asarray(quad), jnp.asarray(img_f), 90, 140))
    assert out.shape == img.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, 1e-4, 1e-4)
    np.testing.assert_allclose(out[80:, 130:], img_f[80:, 130:], atol=1e-6)


def test_default_device_raises_without_a_card(pair):
    """The entry point never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(pair.cfg, pair.state_dict)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(pair.cfg, pair.state_dict, device="cuda:0")
