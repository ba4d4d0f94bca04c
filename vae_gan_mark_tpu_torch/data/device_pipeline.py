"""Input pipeline with the warp on the card (the JAX package's
``data/device_pipeline.py``, the CLI's ``--loader device``).

The host decodes each image and takes an axis-aligned crop of each quad's
bounding box (plus a margin) into a fixed-size uint8 bucket: static
shapes, small transfers. The card solves the homographies and warps the
three streams of a batch (``ops/warp.py:perspective_crop_batch``), then
scales them to [0, 1]. A bounding box larger than the bucket is downscaled
on the host (bilinear) and its quad rescaled to match, so the warp sees
the same geometry.

The price is a second resampling for oversized regions only;
``HostWarpLoader`` (``data/pipeline.py``) stays the reference's path, and
the tests bound the difference between the two (mean abs < 0.02).

On the card the loader uploads and warps on a CUDA stream of its own: the
epoch driver pulls batches on its prefetch thread while the main thread
may be capturing a CUDA graph (``train/graphs.py``), and the warp must not
be recorded into it. A batch is handed over only when its warp has
finished, and its tensors are marked as used by the device's default
stream, where the train step reads them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data.index import Sample
from vae_gan_mark_tpu_torch.data.pipeline import PooledLoader
from vae_gan_mark_tpu_torch.ops.warp import perspective_crop_batch

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

BUCKET_H = 256
BUCKET_W = 1024
MARGIN = 4  # pixels of context around the bbox for bilinear taps
UNIT_QUAD = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def bucket_crop(img: np.ndarray, quad: np.ndarray,
                bucket_h: int = BUCKET_H,
                bucket_w: int = BUCKET_W) -> Tuple[np.ndarray, np.ndarray]:
    """Crop the quad's bounding box (+ ``MARGIN``) into a
    (bucket_h, bucket_w, C) uint8 canvas.

    Returns (bucket, the quad in bucket coordinates). The crop is clipped
    to the image (at least 1 px), aligned top-left, downscaled with PIL's
    bilinear resize when it exceeds the bucket, and edge-padded (the
    warp's replicated border for taps just outside the region). A 2-D
    image gives a one-channel bucket."""
    h, w = img.shape[0], img.shape[1]
    chans = img.shape[2] if img.ndim == 3 else 1
    q = np.asarray(quad, np.float32)
    x0 = int(np.floor(q[:, 0].min())) - MARGIN
    x1 = int(np.ceil(q[:, 0].max())) + MARGIN
    y0 = int(np.floor(q[:, 1].min())) - MARGIN
    y1 = int(np.ceil(q[:, 1].max())) + MARGIN
    x0c, x1c = max(0, x0), min(w, max(x1, x0 + 1))
    y0c, y1c = max(0, y0), min(h, max(y1, y0 + 1))
    crop = img[y0c:y1c, x0c:x1c]
    if crop.ndim == 2:
        crop = crop[..., None]
    ch, cw = crop.shape[0], crop.shape[1]

    scale = min(1.0, bucket_h / ch, bucket_w / cw)
    if scale < 1.0:
        new_h = max(1, int(ch * scale))
        new_w = max(1, int(cw * scale))
        pil = Image.fromarray(crop.squeeze(-1) if chans == 1 else crop)
        pil = pil.resize((new_w, new_h), Image.BILINEAR)
        crop = np.asarray(pil)
        if crop.ndim == 2:
            crop = crop[..., None]
        ch, cw = new_h, new_w

    bucket = np.zeros((bucket_h, bucket_w, chans), np.uint8)
    bucket[:ch, :cw] = crop
    if ch < bucket_h:
        bucket[ch:, :cw] = crop[-1:, :]
    if cw < bucket_w:
        bucket[:, cw:] = bucket[:, cw - 1:cw]

    adj = (q - np.array([x0c, y0c], np.float32)) * scale
    return bucket, adj.astype(np.float32)


def warp_buckets(cfg: VariantConfig, ru: torch.Tensor, ru_q: torch.Tensor,
                 en: torch.Tensor, en_q: torch.Tensor,
                 en_valid: torch.Tensor, mask: torch.Tensor,
                 mask_q: torch.Tensor):
    """Warp the three streams' buckets (B, BUCKET_H, BUCKET_W, C) uint8
    through their quads (B, 4, 2) to (B, patch_h, patch_w, C) float32 in
    [0, 1]; the EN patch is zero where ``en_valid`` (B,) is false."""
    h, w = cfg.patch_h, cfg.patch_w
    ru_p = perspective_crop_batch(ru, ru_q, h, w)
    en_p = perspective_crop_batch(en, en_q, h, w)
    en_p = torch.where(en_valid[:, None, None, None], en_p,
                       torch.zeros_like(en_p))
    mk_p = perspective_crop_batch(mask, mask_q, h, w)
    return ru_p, en_p, mk_p


def _prep_sample(sample: Sample):
    """(ru bucket, ru quad, en bucket, en quad, en valid, mask bucket, mask
    quad, text) of one sample; zero buckets, unit quads, no EN and an
    empty text when it fails to decode, so a batch is never dropped."""
    try:
        ru_img = np.asarray(Image.open(sample.ru_image_path).convert("RGB"))
        if sample.en_image_path:
            en_img = np.asarray(
                Image.open(sample.en_image_path).convert("RGB"))
        else:
            en_img = np.zeros_like(ru_img)
        if sample.mask_path:
            mask_img = np.asarray(
                Image.open(sample.mask_path).convert("L"))[..., None]
        else:
            mask_img = np.zeros(ru_img.shape[:2] + (1,), np.uint8)
        ru_b, ru_q = bucket_crop(ru_img, sample.bbox_ru)
        mk_b, mk_q = bucket_crop(mask_img, sample.bbox_ru)
        if sample.bbox_en:
            en_b, en_q = bucket_crop(en_img, sample.bbox_en)
            en_valid = True
        else:
            en_b = np.zeros((BUCKET_H, BUCKET_W, 3), np.uint8)
            en_q, en_valid = UNIT_QUAD, False
        return ru_b, ru_q, en_b, en_q, en_valid, mk_b, mk_q, sample.text
    except Exception:
        return (np.zeros((BUCKET_H, BUCKET_W, 3), np.uint8), UNIT_QUAD,
                np.zeros((BUCKET_H, BUCKET_W, 3), np.uint8), UNIT_QUAD,
                False, np.zeros((BUCKET_H, BUCKET_W, 1), np.uint8),
                UNIT_QUAD, "")


class DeviceWarpLoader(PooledLoader):
    """Data source (``epoch -> iterator of batches``) like
    ``HostWarpLoader`` (ordering, batching, texts and the decode pool of
    ``PooledLoader``), with the warp on ``device``: each batch holds
    ``ru``, ``en``, ``mask`` as float32 NHWC tensors on the device, and
    ``text`` (int32 tokens, or float32 sentence embeddings for the sbert
    text path from ``text_embed_fn``, else ``hash_embed``) and
    ``raw_text`` on the host. The pool crops the next batch's buckets
    while a batch is warped. ``device`` defaults to ``"cuda"`` and raises
    when no card is present."""

    def __init__(self, cfg: VariantConfig, samples: Sequence[Sample],
                 indices: Sequence[int], batch_size: Optional[int] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 text_embed_fn: Optional[Callable] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceWarpLoader(device={str(device)!r}): no CUDA device "
                "is available; pass device='cpu' to warp on the CPU")
        super().__init__(cfg, samples, indices, batch_size, shuffle,
                         drop_last, seed, num_workers, text_embed_fn)
        self._stream = None

    def _upload(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return tensors
        return [t.pin_memory().to(self.device, non_blocking=True)
                for t in tensors]

    def warp(self, loaded: Sequence[tuple]) -> Tuple[torch.Tensor, ...]:
        """The (ru, en, mask) patches of a batch of ``_prep_sample``
        results, warped on the device; on the card, on the loader's
        stream, finished when this returns."""
        arrays = [np.stack([s[i] for s in loaded]) for i in (0, 1, 2, 3)]
        arrays.append(np.array([s[4] for s in loaded]))
        arrays += [np.stack([s[i] for s in loaded]) for i in (5, 6)]
        if self.device.type != "cuda":
            return warp_buckets(self.cfg, *self._upload(arrays))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            patches = warp_buckets(self.cfg, *self._upload(arrays))
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        consumer = torch.cuda.default_stream(self.device)
        for t in patches:
            t.record_stream(consumer)
        return patches

    def _load(self, sample: Sample):
        return _prep_sample(sample)

    def _finish(self, loaded: list) -> dict:
        ru, en, mask = self.warp(loaded)
        texts = [s[7] for s in loaded]
        return {"ru": ru, "en": en, "mask": mask,
                "text": self._encode_text(texts), "raw_text": texts}
