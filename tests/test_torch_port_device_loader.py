"""The device-warp loader (``vae_gan_mark_tpu_torch/data/device_pipeline.py``,
the train CLI's ``--loader device``) against the JAX package's
``data/device_pipeline.py``, on the CPU at the tiny geometry.

Tolerances, and why:

* ``bucket_crop``: bit for bit. Both sides are numpy and PIL.
* ``warp_buckets`` and the loader's batches against JAX's: atol 1e-4, rtol
  1e-4 (the limit of ``tests/test_torch_port_ops.py``'s warp test): two
  float32 homography solves and bilinear taps in another order.
* The loader against the port's ``HostWarpLoader``: mean abs < 0.02 per
  stream (``tests/test_device_pipeline.py``): cv2's fixed-point warp
  against a float one, and a second resampling of regions larger than the
  bucket.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.data import device_pipeline as jax_dp
from vae_gan_mark_tpu.data.index import build_index as jax_build_index
from vae_gan_mark_tpu_torch import cli
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.data import device_pipeline as dp
from vae_gan_mark_tpu_torch.data.index import build_index
from vae_gan_mark_tpu_torch.data.pipeline import HostWarpLoader
from vae_gan_mark_tpu_torch.data.text_embed import hash_embed

from test_data import make_dataset
from torch_port_common import TINY

GEOMETRY = dict(patch_h=32, patch_w=64, max_text_len=12, batch_size=4,
                compute_dtype="float32")
WARP_TOL = dict(atol=1e-4, rtol=1e-4)


def indexes(dirs):
    args = (dirs["json"], dirs["ru"], dirs["en"], dirs["mask"])
    return build_index(*args), jax_build_index(*args)


def crop_case(name):
    rng = np.random.default_rng(0)
    if name == "in_image":
        img = rng.integers(0, 255, (200, 300, 3), dtype=np.uint8)
        quad = [[50, 60], [120, 58], [118, 100], [48, 98]]
    elif name == "past_the_edge":
        img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
        quad = [[-10, 90], [150.5, 95], [170.2, 130], [-3, 125.7]]
    elif name == "oversized":
        img = rng.integers(0, 255, (700, 1500, 3), dtype=np.uint8)
        quad = [[3, 2], [1490, 10], [1480, 690], [5, 680]]
    else:                                               # a 2-D mask
        img = (rng.uniform(0, 1, (240, 320)) > 0.5).astype(np.uint8) * 255
        quad = [[20.5, 30], [120, 31], [119, 70.5], [21, 72]]
    return img, np.asarray(quad, np.float32)


@pytest.mark.parametrize("case", ["in_image", "past_the_edge", "oversized",
                                  "mask_2d"])
def test_bucket_crop_matches_jax_bit_for_bit(case):
    img, quad = crop_case(case)
    bucket, adj = dp.bucket_crop(img, quad)
    ref_bucket, ref_adj = jax_dp.bucket_crop(img, quad)
    assert bucket.shape == (dp.BUCKET_H, dp.BUCKET_W,
                            3 if img.ndim == 3 else 1)
    assert bucket.dtype == ref_bucket.dtype == np.uint8
    assert np.array_equal(bucket, ref_bucket)
    assert adj.dtype == ref_adj.dtype and np.array_equal(adj, ref_adj)
    if case == "oversized":
        assert adj[:, 0].max() <= dp.BUCKET_W and adj[:, 1].max() <= \
            dp.BUCKET_H


def test_warp_buckets_match_jax():
    cfg, jcfg = get_config("v2", **GEOMETRY), jax_get_config("v2", **GEOMETRY)
    cases = [crop_case(c) for c in ("in_image", "past_the_edge", "oversized")]
    ru = [dp.bucket_crop(img, q) for img, q in cases]
    mask = [dp.bucket_crop(crop_case("mask_2d")[0], q) for _, q in cases]
    args = (np.stack([b for b, _ in ru]), np.stack([q for _, q in ru]),
            np.stack([b for b, _ in ru[::-1]]),
            np.stack([q for _, q in ru[::-1]]),
            np.array([True, False, True]), np.stack([b for b, _ in mask]),
            np.stack([q for _, q in mask]))
    got = dp.warp_buckets(cfg, *[torch.from_numpy(a) for a in args])
    ref = jax_dp.warp_buckets(jcfg, *[jnp.asarray(a) for a in args])
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **WARP_TOL)
    assert not got[1][1].any()                          # en_valid False
    assert 0.0 <= float(got[0].min()) and float(got[0].max()) <= 1.0


def loaders(dirs, variant="v2", **kwargs):
    (samples, jax_samples) = indexes(dirs)
    cfg = get_config(variant, **GEOMETRY)
    jcfg = jax_get_config(variant, **GEOMETRY)
    idx = list(range(len(samples)))
    common = dict(batch_size=5, shuffle=True, drop_last=False, seed=3,
                  num_workers=2, **kwargs)
    return (dp.DeviceWarpLoader(cfg, samples, idx, device="cpu", **common),
            jax_dp.DeviceWarpLoader(jcfg, jax_samples, idx, **common),
            HostWarpLoader(cfg, samples, idx, **common))


@pytest.mark.parametrize("missing_en", [False, True])
def test_device_loader_matches_jax_and_the_host_loader(tmp_path, missing_en):
    """Every batch of an epoch (shuffled from the seed, the last one short)
    against JAX's device loader, and against the port's host loader; a
    missing EN image gives a zero EN patch, a sample without an EN quad a
    zero one too."""
    dirs = make_dataset(str(tmp_path), n_images=3, missing_en=missing_en)
    port, ref, host = loaders(dirs)
    got, want, host_batches = (list(loader(1)) for loader in
                               (port, ref, host))
    assert len(port) == len(ref) == len(got) == len(want) == 3
    for g, r, h in zip(got, want, host_batches):
        assert g["raw_text"] == r["raw_text"] == h["raw_text"]
        assert g["text"].dtype == np.int32
        np.testing.assert_array_equal(g["text"], np.asarray(r["text"]))
        np.testing.assert_array_equal(g["text"], h["text"])
        for key in ("ru", "en", "mask"):
            assert isinstance(g[key], torch.Tensor) and g[key].device.type \
                == "cpu" and g[key].dtype == torch.float32
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]),
                                       err_msg=key, **WARP_TOL)
            assert float(np.mean(np.abs(g[key].numpy() - h[key]))) < 0.02
    rows = [(b["raw_text"][i], b["en"][i]) for b in got
            for i in range(len(b["raw_text"]))]
    assert not [t for t, en in rows if t == "null en bbox" and en.any()]
    if missing_en:          # image 0 has no EN file: zero patches
        samples = indexes(dirs)[0]
        no_en = {s.text for s in samples if s.en_image_path is None}
        assert no_en and all(not en.any() for t, en in rows if t in no_en)


def test_broken_sample_gives_zero_buckets(tmp_path):
    dirs = make_dataset(str(tmp_path), n_images=1)
    samples, _ = indexes(dirs)
    samples[0].ru_image_path = str(tmp_path / "missing.jpg")
    loaded = dp._prep_sample(samples[0])
    assert loaded[7] == "" and loaded[4] is False
    for i in (0, 2, 5):
        assert loaded[i].shape[:2] == (dp.BUCKET_H, dp.BUCKET_W)
        assert not loaded[i].any()
    batch = next(iter(dp.DeviceWarpLoader(
        get_config("v2", **GEOMETRY), samples, [0, 1, 2, 3], shuffle=False,
        num_workers=1, device="cpu")(0)))
    assert batch["raw_text"][0] == "" and not batch["ru"][0].any()
    assert not batch["text"][0].any() and batch["ru"][1].any()


def test_sbert_text_path(tmp_path):
    """vanilla: ``text`` is ``text_embed_fn(texts)``, or ``hash_embed``
    (as JAX's loader gives it) without one."""
    dirs = make_dataset(str(tmp_path), n_images=1)
    port, ref, _ = loaders(dirs, variant="vanilla")
    got, want = next(iter(port(0))), next(iter(ref(0)))
    assert got["text"].dtype == np.float32
    np.testing.assert_array_equal(got["text"], np.asarray(want["text"]))
    np.testing.assert_array_equal(got["text"],
                                  hash_embed(got["raw_text"], 384))
    samples, _ = indexes(dirs)
    fixed = dp.DeviceWarpLoader(
        get_config("vanilla", **GEOMETRY), samples, [0, 1], batch_size=2,
        shuffle=False,
        device="cpu", text_embed_fn=lambda texts: np.full(
            (len(texts), 384), len(texts[0]), np.float32))
    batch = next(iter(fixed(0)))
    assert batch["text"].shape == (2, 384)
    assert (batch["text"][0] == len(batch["raw_text"][0])).all()


def test_loader_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.DeviceWarpLoader(get_config("v2", **GEOMETRY), [], [])


TINY_SET = [f"--set={k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]


def disk_args(dirs, workdir):
    return ["--json-dir", dirs["json"], "--ru-dir", dirs["ru"], "--en-dir",
            dirs["en"], "--mask-dir", dirs["mask"], "--workdir", workdir,
            "--device", "cpu", "--batch-size", "4", "--num-workers", "2",
            *TINY_SET]


def test_train_cli_trains_through_the_device_loader(tmp_path, capsys):
    dirs = make_dataset(str(tmp_path / "data"), n_images=6)
    workdir = str(tmp_path / "run")
    cli.main(disk_args(dirs, workdir) + ["--loader", "device", "--epochs",
                                          "1"])
    out = capsys.readouterr().out
    assert "--loader device is experimental" in out
    with open(os.path.join(workdir, "v2.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [1]
    assert np.isfinite(records[0]["train/generator_loss"])
    assert records[0]["train/images_per_sec"] > 0
    assert os.path.isdir(os.path.join(workdir, "last_checkpoint"))


def test_train_cli_refuses_patch_cache_with_the_device_loader(tmp_path):
    dirs = make_dataset(str(tmp_path / "data"), n_images=1)
    with pytest.raises(SystemExit, match="--patch-cache requires --loader "
                                         "host"):
        cli.main(disk_args(dirs, str(tmp_path / "run"))
                 + ["--loader", "device", "--patch-cache",
                    str(tmp_path / "cache")])
