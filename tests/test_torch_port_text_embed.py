"""The port's sbert text path on the host, against the JAX package: its own
copy of ``data/text_embed.py`` (``hash_embed`` bit for bit,
``make_text_embedder``'s strict and loose modes with a stubbed
``SentenceTransformer``, as tests/test_text_embed.py stubs it), the
synthetic sbert batches (bit for bit in one process), the host loader and
the engine with a ``text_embed_fn``, and the serve and eval CLIs, which
refuse an sbert variant without ``--allow-hash-embed``."""

import sys
import types

import numpy as np
import pytest

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.data import text_embed as jax_text_embed
from vae_gan_mark_tpu.data.synthetic import (
    SyntheticPatchDataset as JaxSyntheticPatchDataset)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data import text_embed
from vae_gan_mark_tpu_torch.data.pipeline import HostWarpLoader
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
from vae_gan_mark_tpu_torch.eval import __main__ as eval_cli
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.serve import __main__ as serve_cli

from test_data import make_dataset
from torch_port_common import TINY, Pair

TEXTS = ["", "SALE", "SALE ", "скидка 50%", "x" * 200]


class _StubSentenceTransformer:
    """A stand-in for ``sentence_transformers.SentenceTransformer``: one
    seeded vector a text, float64 as the real ``encode`` may return."""

    def __init__(self, model_name, device="cpu", **kwargs):
        self.model_name, self.kwargs = model_name, kwargs

    def get_sentence_embedding_dimension(self):
        return 384

    def encode(self, texts, convert_to_numpy=True):
        return np.stack([np.random.default_rng(len(t) + 7).normal(0, 1, 384)
                         for t in texts])


def _raise(*args, **kwargs):
    raise OSError("no cached model")


def stub_module(monkeypatch, factory):
    mod = types.ModuleType("sentence_transformers")
    mod.SentenceTransformer = factory
    monkeypatch.setitem(sys.modules, "sentence_transformers", mod)


@pytest.mark.parametrize("dim", [384, 16])
def test_hash_embed_equals_jax(dim):
    got = text_embed.hash_embed(TEXTS, dim)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), dim)
    np.testing.assert_array_equal(got, jax_text_embed.hash_embed(TEXTS, dim))
    assert not np.array_equal(got[1], got[2])


@pytest.mark.parametrize("variant", ["vanilla", "lr_sh"])
def test_synthetic_sbert_batches_equal_jax(variant):
    """Same process, same salted ``hash()``: the same embeddings."""
    ds = SyntheticPatchDataset(get_config(variant, **TINY), 12, seed=3)
    ref = JaxSyntheticPatchDataset(jax_get_config(variant, **TINY), 12,
                                   seed=3)
    for step in (0, 1):
        a, b = ds.batch(4, step), ref.batch(4, step)
        assert a["text"].dtype == np.float32
        assert a["text"].shape == (4, 384)
        assert a["raw_text"] == b["raw_text"]
        for key in ("ru", "en", "mask", "text"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sbert_embedder_reads_the_local_cache_only(monkeypatch):
    stub_module(monkeypatch, _StubSentenceTransformer)
    emb = text_embed.SbertEmbedder()
    assert emb.model.model_name == text_embed.SBERT_MODEL_NAME
    assert emb.model.kwargs == {"local_files_only": True}
    assert emb.dim == 384
    out = emb(["a", "bb"])
    assert out.shape == (2, 384) and out.dtype == np.float32
    loader = HostWarpLoader(get_config("vanilla"), [], [], text_embed_fn=emb)
    np.testing.assert_array_equal(loader._encode_text(["a", "bb"]), out)


def test_make_text_embedder_strict_raises_and_loose_falls_back(
        monkeypatch, capsys):
    stub_module(monkeypatch, _raise)
    with pytest.raises(RuntimeError, match="allow-hash-embed"):
        text_embed.make_text_embedder(require_sbert=True)
    fn = text_embed.make_text_embedder()
    assert "WARNING: SBERT unavailable" in capsys.readouterr().err
    np.testing.assert_array_equal(fn(TEXTS), text_embed.hash_embed(TEXTS))
    stub_module(monkeypatch, _StubSentenceTransformer)
    assert isinstance(text_embed.make_text_embedder(require_sbert=True),
                      text_embed.SbertEmbedder)


def test_engine_embeds_with_text_embed_fn():
    """Without a function the engine's texts go through ``hash_embed``;
    with one, through it."""
    pair = Pair("vanilla", **TINY)
    image, mask, _, _ = pair.inputs(3)
    texts = ["a", "b", "c"]
    calls = []

    def embed(batch_texts):
        calls.append(list(batch_texts))
        return text_embed.hash_embed(batch_texts)

    plain = InferenceEngine(pair.cfg, pair.state_dict, batch_size=4,
                            device="cpu")
    given = InferenceEngine(pair.cfg, pair.state_dict, batch_size=4,
                            device="cpu", text_embed_fn=embed)
    enc = plain._encode_texts(texts)
    assert enc.dtype == np.float32 and enc.shape == (3, 384)
    np.testing.assert_array_equal(
        plain.generate(image, mask, texts), given.generate(image, mask,
                                                            texts))
    assert calls == [texts + [""]]


def test_serve_and_eval_clis_refuse_without_allow_hash_embed(
        monkeypatch, tmp_path):
    """Both stop before reading any checkpoint: serve always embeds; eval
    embeds the texts of an on-disk dataset."""
    from PIL import Image
    stub_module(monkeypatch, _raise)
    img = tmp_path / "in.png"
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(img)
    with pytest.raises(RuntimeError, match="allow-hash-embed"):
        serve_cli.main(["--variant", "vanilla", "--workdir", str(tmp_path),
                        "--image", str(img), "--mask", str(img), "--quad",
                        "0,0,63,0,63,63,0,63", "--text", "t", "--out",
                        str(tmp_path / "o.png"), "--device", "cpu"])
    dirs = make_dataset(str(tmp_path / "data"), n_images=2)
    (tmp_path / "run" / "best_model").mkdir(parents=True)
    (tmp_path / "run" / "best_model" / "host_meta.json").write_text(
        '{"epoch": 0}')
    with pytest.raises(RuntimeError, match="allow-hash-embed"):
        eval_cli.main(["--variant", "lr_sh", "--workdir",
                       str(tmp_path / "run"), "--json-dir", dirs["json"],
                       "--ru-dir", dirs["ru"], "--en-dir", dirs["en"],
                       "--mask-dir", dirs["mask"], "--device", "cpu"])
