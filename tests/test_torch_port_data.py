"""The port's on-disk data path against the JAX package's, on a tiny dataset
made as tests/test_data.py makes it: the index and the grouped split, the
host loader's batches (cv2 and the native warp forced), the zero-dummy
samples, the native library's own build, and the patch cache. Every
comparison is exact: both sides decode the same files with the same
libraries and must give the same arrays, bit for bit."""

import json
import os

import numpy as np
import pytest

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.data import native_warp as jax_native_warp
from vae_gan_mark_tpu.data import pipeline as jax_pipeline
from vae_gan_mark_tpu.data.index import (
    build_index as jax_build_index, grouped_split as jax_grouped_split)
from vae_gan_mark_tpu.data.patch_cache import (
    PatchCache as JaxPatchCache, dataset_fingerprint as jax_fingerprint)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data import native_warp, pipeline
from vae_gan_mark_tpu_torch.data import patch_cache
from vae_gan_mark_tpu_torch.data.index import build_index, grouped_split
from vae_gan_mark_tpu_torch.data.text_embed import hash_embed

from test_data import make_dataset

GEOMETRY = dict(patch_h=32, patch_w=64, max_text_len=12, batch_size=4)


def configs():
    return get_config("v2", **GEOMETRY), jax_get_config("v2", **GEOMETRY)


def indexes(dirs):
    args = (dirs["json"], dirs["ru"], dirs["en"], dirs["mask"])
    return build_index(*args), jax_build_index(*args)


def assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        assert a["raw_text"] == b["raw_text"]
        for key in ("ru", "en", "mask", "text"):
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("missing_en", [False, True])
def test_index_and_split_match_jax(tmp_path, missing_en):
    dirs = make_dataset(str(tmp_path), n_images=10, missing_en=missing_en)
    got, ref = indexes(dirs)
    assert len(got) == len(ref) == 40
    assert [vars(s) for s in got] == [vars(s) for s in ref]
    for fraction, seed in ((0.1, 42), (0.3, 7)):
        assert grouped_split(got, fraction, seed) == jax_grouped_split(
            ref, fraction, seed)
    assert grouped_split([]) == jax_grouped_split([])


@pytest.mark.parametrize("force_native", [False, True],
                         ids=["cv2", "native_warp"])
def test_host_loader_matches_jax(tmp_path, monkeypatch, force_native):
    if force_native:
        if not native_warp.available():
            pytest.skip("the native warp library cannot be built here")
        monkeypatch.setattr(pipeline, "_FORCE_NATIVE", True)
        monkeypatch.setattr(jax_pipeline, "_FORCE_NATIVE", True)
    else:
        pytest.importorskip("cv2")
    dirs = make_dataset(str(tmp_path), n_images=3, missing_en=True)
    (samples, jax_samples), (cfg, jcfg) = indexes(dirs), configs()
    idx = list(range(len(samples)))
    for kw in (dict(shuffle=True, drop_last=True, seed=3),
               dict(shuffle=False, drop_last=False)):
        loader = pipeline.HostWarpLoader(cfg, samples, idx, num_workers=2,
                                         **kw)
        ref = jax_pipeline.HostWarpLoader(jcfg, jax_samples, idx,
                                          num_workers=2, **kw)
        assert len(loader) == len(ref)
        for epoch in (0, 1):
            assert_batches_equal(loader(epoch), ref(epoch))


def test_broken_sample_gives_zero_dummies(tmp_path):
    dirs = make_dataset(str(tmp_path), n_images=1)
    (samples, jax_samples), (cfg, jcfg) = indexes(dirs), configs()
    for s in (samples[0], jax_samples[0]):
        s.ru_image_path = str(tmp_path / "missing.jpg")
    got = pipeline.load_sample(samples[0], cfg)
    ref = jax_pipeline.load_sample(jax_samples[0], jcfg)
    assert got[3] == ref[3] == ""
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and not a.any() and np.array_equal(a, b)
    batch = next(iter(pipeline.HostWarpLoader(
        cfg, samples, [0, 1, 2, 3], shuffle=False, num_workers=1)(0)))
    assert batch["raw_text"][0] == "" and not batch["ru"][0].any()
    assert not batch["text"][0].any() and batch["ru"][1].any()


def test_native_library_builds_and_matches(tmp_path, monkeypatch):
    """The port's loader compiles ``native/warp.cc`` itself when the
    library is missing (here into a temporary path), and the result warps
    as the JAX package's binding does."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    if not jax_native_warp.available():
        pytest.skip("the JAX package's native library is unavailable")
    monkeypatch.setattr(native_warp, "_LIB_PATH",
                        str(tmp_path / "libvgm_host.so"))
    monkeypatch.setattr(native_warp, "_lib", None)
    monkeypatch.setattr(native_warp, "_load_failed", False)
    assert native_warp.available()
    assert os.listdir(tmp_path) == ["libvgm_host.so"]
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    quad = np.array([[10, 12], [150, 8], [148, 100], [12, 110]], np.float32)
    for image in (img, img[..., 0]):
        got = native_warp.perspective_crop(image, quad, 64, 32)
        assert np.array_equal(
            got, jax_native_warp.perspective_crop(image, quad, 64, 32))


def test_patch_cache_matches_jax(tmp_path):
    dirs = make_dataset(str(tmp_path), n_images=3)
    (samples, jax_samples), (cfg, jcfg) = indexes(dirs), configs()
    os.truncate(samples[0].ru_image_path, 3)         # one broken sample
    assert patch_cache.dataset_fingerprint(cfg, samples, "chars12") == \
        jax_fingerprint(jcfg, jax_samples, "chars12")
    idx = list(range(len(samples)))
    kw = dict(shuffle=True, drop_last=True, seed=1, num_workers=2)
    loader = pipeline.HostWarpLoader(cfg, samples, idx,
                                     cache_dir=str(tmp_path / "port"), **kw)
    ref = jax_pipeline.HostWarpLoader(jcfg, jax_samples, idx,
                                      cache_dir=str(tmp_path / "jax"), **kw)
    for epoch in (0, 1):          # epoch 1 reads the filled memmap only
        assert_batches_equal(loader(epoch), ref(epoch))
    jax_cache = JaxPatchCache(str(tmp_path / "jax"), jcfg, jax_samples)
    for name in ("patches", "filled", "ok", "text"):
        assert np.array_equal(getattr(loader.cache, name),
                              getattr(jax_cache, name)), name
    assert not loader.cache.ok[[i for i, s in enumerate(samples)
                                if s.ru_image_path ==
                                samples[0].ru_image_path]].any()


def test_patch_cache_persists_invalidates_and_prewarms(tmp_path, capsys):
    dirs = make_dataset(str(tmp_path), n_images=2)
    samples, _ = indexes(dirs)
    cfg = configs()[0]
    cache_dir = str(tmp_path / "cache")
    patch_cache.main(["--variant", "v2", "--json-dir", dirs["json"],
                      "--ru-dir", dirs["ru"], "--en-dir", dirs["en"],
                      "--mask-dir", dirs["mask"], "--cache-dir", cache_dir,
                      "--num-workers", "2"])
    assert f"{len(samples)} samples cached" in capsys.readouterr().out
    full = get_config("v2")
    assert int(patch_cache.PatchCache(cache_dir, full, samples)
               .filled.min()) == 2                        # reopened, kept
    assert int(patch_cache.PatchCache(cache_dir, cfg, samples)
               .filled.max()) == 0                        # geometry changed
    # vanilla caches too, its texts as sbert embeddings (text mode
    # sbert384); without a cached SBERT model only with --allow-hash-embed.
    sbert_dir = str(tmp_path / "sbert_cache")
    patch_cache.main(["--variant", "vanilla", "--json-dir", dirs["json"],
                      "--ru-dir", dirs["ru"], "--en-dir", dirs["en"],
                      "--mask-dir", dirs["mask"], "--cache-dir", sbert_dir,
                      "--num-workers", "2", "--allow-hash-embed"])
    assert f"{len(samples)} samples cached" in capsys.readouterr().out
    with open(os.path.join(sbert_dir, "meta.json")) as f:
        assert json.load(f)["text_mode"] == "sbert384"
    cache = patch_cache.PatchCache(sbert_dir, get_config("vanilla"), samples)
    assert int(cache.filled.min()) == 2
    assert cache.text.dtype == np.float32 and cache.text.shape == (
        len(samples), 384)
    texts = [cache._row_text(i) for i in range(len(samples))]
    np.testing.assert_array_equal(np.asarray(cache.text),
                                  hash_embed(texts))
