"""Host input pipeline for on-disk data (the JAX package's
``data/pipeline.py``, its host loader).

``HostWarpLoader`` decodes each sample with PIL and warps its quad to the
patch with cv2 (or, without cv2, the native C++ warp of
``data/native_warp.py``, which agrees with cv2 to one gray level) on worker
threads, as the reference's DataLoader workers do. The reference's defences
stay: a sample that fails to load gives zero images and an empty text, and a
batch that loses every sample is ``None``. Batches are dicts of numpy
arrays {ru, en, mask: NHWC float32 in [0, 1], text, raw_text}; ``text``
holds int32 char tokens, or for the sbert text path (B, sbert_dim) float32
embeddings from ``text_embed_fn`` (``hash_embed`` without one). The
trainer moves them to the card. ``cache_dir`` streams decoded patches
from ``data/patch_cache.py`` after their first decode. ``PooledLoader``
holds what it shares with the device loader (``data/device_pipeline.py``):
the order, the batches, the texts and the decode pool.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data.index import Sample
from vae_gan_mark_tpu_torch.data.text_embed import encode_texts
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer

try:
    import cv2
except ImportError:
    cv2 = None

try:
    from PIL import Image
except ImportError:
    Image = None

# Forces the native C++ warp even when cv2 is present (tests set it).
_FORCE_NATIVE = bool(os.environ.get("VGM_FORCE_NATIVE_WARP"))


def _host_perspective_crop(img: np.ndarray, bbox, out_w: int,
                           out_h: int) -> np.ndarray:
    """The reference's warp: the quad's corners to the patch's corners,
    bilinear, replicated border."""
    pts_src = np.asarray(bbox, np.float32).reshape(4, 2)
    if cv2 is not None and not _FORCE_NATIVE:
        pts_dst = np.array([[0, 0], [out_w - 1, 0], [out_w - 1, out_h - 1],
                            [0, out_h - 1]], np.float32)
        m = cv2.getPerspectiveTransform(pts_src, pts_dst)
        return cv2.warpPerspective(img, m, (out_w, out_h),
                                   flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_REPLICATE)
    from vae_gan_mark_tpu_torch.data import native_warp
    if not native_warp.available():
        raise RuntimeError("neither cv2 nor the native warp library is "
                           "available (g++ could not build native/warp.cc)")
    return native_warp.perspective_crop(img, pts_src, out_w, out_h)


def load_sample(sample: Sample, cfg: VariantConfig):
    """Decode and warp one sample -> (ru, en, mask) float32 HWC in [0, 1]
    and its text; zero images and "" on any failure."""
    h, w = cfg.patch_h, cfg.patch_w
    try:
        ru_img = np.asarray(Image.open(sample.ru_image_path).convert("RGB"))
        if sample.en_image_path:
            en_img = np.asarray(
                Image.open(sample.en_image_path).convert("RGB"))
        else:
            en_img = np.zeros_like(ru_img)
        if sample.mask_path:
            mask_img = np.asarray(
                Image.open(sample.mask_path).convert("L"))
        else:
            mask_img = np.zeros(ru_img.shape[:2], np.uint8)

        ru = _host_perspective_crop(ru_img, sample.bbox_ru, w, h)
        if sample.bbox_en:
            en = _host_perspective_crop(en_img, sample.bbox_en, w, h)
        else:
            en = np.zeros((h, w, 3), np.uint8)
        mask = _host_perspective_crop(mask_img, sample.bbox_ru, w, h)
        return (ru.astype(np.float32) / 255.0,
                en.astype(np.float32) / 255.0,
                mask.astype(np.float32)[..., None] / 255.0,
                sample.text)
    except Exception:
        return (np.zeros((h, w, 3), np.float32),
                np.zeros((h, w, 3), np.float32),
                np.zeros((h, w, 1), np.float32),
                "")


class PooledLoader:
    """What the loaders share: a data source (``epoch -> iterator of
    batches``) over a subset of the index; with ``shuffle`` the order is a
    permutation drawn from ``seed + epoch``, and ``drop_last`` drops a last
    partial batch. Each sample goes through ``_load`` on a pool of
    ``num_workers`` threads and each batch of them through ``_finish``;
    the next batch's samples are submitted before a batch is finished, so
    the pool decodes while ``_finish`` and the consumer run.
    ``text_embed_fn``: texts -> (B, sbert_dim) for the sbert text path
    (``data/text_embed.py:make_text_embedder``)."""

    def __init__(self, cfg: VariantConfig, samples: Sequence[Sample],
                 indices: Sequence[int], batch_size: Optional[int] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 text_embed_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.samples = samples
        self.indices = list(indices)
        self.batch_size = batch_size or cfg.batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.tokenizer = CharTokenizer(cfg.alphabet, cfg.max_text_len)
        self.text_embed_fn = text_embed_fn

    def __len__(self):
        n = len(self.indices)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        return encode_texts(self.cfg, self.tokenizer, self.text_embed_fn,
                            texts)

    def _batches(self, epoch: int) -> List[np.ndarray]:
        """The epoch's batches of sample indices, in order."""
        order = np.asarray(self.indices)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + epoch).permutation(order)
        b = self.batch_size
        limit = len(order) - (len(order) % b) if self.drop_last else len(order)
        return [order[start:start + b] for start in range(0, limit, b)]

    def _load(self, sample: Sample):
        """One sample, on a worker thread."""
        raise NotImplementedError

    def _finish(self, loaded: list):
        """The batch of a list of ``_load`` results."""
        raise NotImplementedError

    def __call__(self, epoch: int) -> Iterator[dict]:
        batches = self._batches(epoch)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def submit(chunk):
                return [pool.submit(self._load, self.samples[int(i)])
                        for i in chunk]

            pending = submit(batches[0]) if batches else []
            for n in range(len(batches)):
                loaded = [f.result() for f in pending]
                if n + 1 < len(batches):
                    pending = submit(batches[n + 1])
                yield self._finish(loaded)


class HostWarpLoader(PooledLoader):
    """``PooledLoader`` that decodes and warps each sample on the host
    (``load_sample``): batches of numpy arrays. ``cache_dir`` streams
    decoded patches from ``data/patch_cache.py`` after their first
    decode."""

    def __init__(self, cfg: VariantConfig, samples: Sequence[Sample],
                 indices: Sequence[int], batch_size: Optional[int] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 text_embed_fn: Optional[Callable] = None,
                 cache_dir: Optional[str] = None):
        super().__init__(cfg, samples, indices, batch_size, shuffle,
                         drop_last, seed, num_workers, text_embed_fn)
        self.cache = None
        if cache_dir is not None:
            from vae_gan_mark_tpu_torch.data.patch_cache import PatchCache
            self.cache = PatchCache(cache_dir, cfg, samples,
                                    text_embed_fn=text_embed_fn)

    def _load(self, sample: Sample):
        return load_sample(sample, self.cfg)

    def _finish(self, loaded: list) -> Optional[dict]:
        if not loaded:
            return None
        ru = np.stack([s[0] for s in loaded])
        en = np.stack([s[1] for s in loaded])
        mask = np.stack([s[2] for s in loaded])
        texts = [s[3] for s in loaded]
        return {"ru": ru, "en": en, "mask": mask,
                "text": self._encode_text(texts), "raw_text": texts}

    def __call__(self, epoch: int) -> Iterator[dict]:
        if self.cache is None:
            yield from super().__call__(epoch)
            return
        for chunk in self._batches(epoch):
            yield self.cache.batch(chunk, self.num_workers)
