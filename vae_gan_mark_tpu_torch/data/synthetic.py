"""Synthetic dataset for tests, smoke runs and benchmarks (a copy of the JAX
package's ``data/synthetic.py``: for the same seed and options it gives the
same arrays, bit for bit).

Batches (ru, en, mask, text) have a learnable, text-dependent ru -> en
mapping, as in the reference task, where the EN patch is the masked region
re-rendered with the target text:

  * outside the mask: the "ru" patch unchanged;
  * inside the mask: the channels of "ru" rotated (style carry-over), with
    the target text drawn on top in white with a PIL bitmap font.

``text_dependent=False`` keeps the channel rotation alone and needs no
Pillow. Batches are numpy; ``train/step.py:batch_to_device`` moves one to a
device, and ``raw_text`` (a list of str) stays on the host. ``text`` holds
char tokens, or for the sbert text path pseudo-embeddings keyed by
Python's ``hash()`` of the string, as in the JAX package: ``hash`` is
salted per process, so they change between processes unless
``PYTHONHASHSEED`` is set.
"""

from __future__ import annotations

import string

import numpy as np

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer


def render_text_tiled(text: str, h: int, w: int,
                      cell_h: int = 16) -> np.ndarray:
    """Rasterize ``text`` tiled across an (h, w) canvas, watermark-style.

    Rows every ``cell_h`` pixels, each row the string repeated at a fixed
    horizontal stride, odd rows shifted by half a stride. Deterministic;
    returns float32 alpha in [0, 1].
    """
    from PIL import Image, ImageDraw, ImageFont
    size = max(6, int(cell_h * 0.75))
    try:
        font = ImageFont.load_default(size=size)
    except TypeError:  # older Pillow: fixed-size raster font
        font = ImageFont.load_default()
    img = Image.new("L", (w, h), 0)
    d = ImageDraw.Draw(img)
    try:
        stride = max(int(d.textlength(text, font=font)), 8) + 12
    except AttributeError:
        stride = 7 * max(len(text), 1) + 12
    for r, y in enumerate(range(0, h, cell_h)):
        x = -(stride // 2) if r % 2 else 0
        while x < w:
            d.text((x, y), text, font=font, fill=255)
            x += stride
    return np.asarray(img, np.float32) / 255.0


def render_text_raster(text: str, mh: int, mw: int) -> np.ndarray:
    """Rasterize ``text`` into a (mh, mw) float32 alpha map in [0, 1], with
    a PIL bitmap font sized to the region's height."""
    from PIL import Image, ImageDraw, ImageFont
    size = max(6, int(mh * 0.6))
    try:
        font = ImageFont.load_default(size=size)
    except TypeError:  # older Pillow: fixed-size raster font
        font = ImageFont.load_default()
    img = Image.new("L", (mw, mh), 0)
    ImageDraw.Draw(img).text((2, max(0, (mh - size) // 2 - 1)), text,
                             font=font, fill=255)
    return np.asarray(img, np.float32) / 255.0


def smooth_backgrounds(rng: np.random.Generator, n: int, h: int,
                       w: int, cell: int = 16) -> np.ndarray:
    """Low-res noise bilinearly upsampled to (n, h, w, 3) in [0, 1]: smooth
    colour fields, which the patch discriminator can match, instead of
    per-pixel noise, which it cannot."""
    from PIL import Image
    coarse = rng.uniform(40, 215, (n, max(h // cell, 2),
                                   max(w // cell, 2), 3))
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        img = Image.fromarray(coarse[i].astype(np.uint8))
        out[i] = np.asarray(img.resize((w, h), Image.BILINEAR),
                            np.float32) / 255.0
    return out


class SyntheticPatchDataset:
    def __init__(self, cfg: VariantConfig, num_samples: int = 256,
                 seed: int = 0, text_dependent: bool = True,
                 texts: list = None, text_vocab: int = 0,
                 text_tile: bool = False, structured: bool = False):
        self.cfg = cfg
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)
        h, w = cfg.patch_h, cfg.patch_w
        if structured:
            self.ru = smooth_backgrounds(self.rng, num_samples, h, w)
        else:
            self.ru = self.rng.uniform(
                0, 1, (num_samples, h, w, 3)).astype(np.float32)
        # Rectangular "text region" masks.
        self.mask = np.zeros((num_samples, h, w, 1), np.float32)
        boxes = []
        for i in range(num_samples):
            y0 = int(self.rng.integers(0, h // 2))
            x0 = int(self.rng.integers(0, w // 2))
            self.mask[i, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
            boxes.append((y0, x0))
        alphabet = cfg.alphabet
        printable = [c for c in alphabet if c in string.printable
                     and c != " "] or list(alphabet)
        if texts is not None:
            assert len(texts) == num_samples
            self.texts = list(texts)
        elif text_vocab > 0:
            # A closed vocabulary of mark strings, the same for every
            # dataset seed, as real watermark corpora repeat a few marks.
            vocab_rng = np.random.default_rng(0x5EED + text_vocab)
            vocab = [
                "".join(vocab_rng.choice(printable,
                                         size=vocab_rng.integers(3, 20)))
                for _ in range(text_vocab)]
            self.texts = [vocab[int(self.rng.integers(0, text_vocab))]
                          for _ in range(num_samples)]
        else:
            self.texts = [
                "".join(self.rng.choice(printable,
                                        size=self.rng.integers(3, 20)))
                for _ in range(num_samples)]
        # en = ru with channels rotated inside the mask, plus (when
        # text_dependent) the target text in white inside the mask.
        self.en = np.where(self.mask > 0, self.ru[..., [1, 2, 0]], self.ru)
        if text_dependent and text_tile:
            # The string tiled at fixed absolute positions across the
            # patch, visible only inside the mask; one raster per string.
            rasters = {}
            for i in range(num_samples):
                t = self.texts[i]
                if t not in rasters:
                    rasters[t] = render_text_tiled(t, h, w)[..., None]
                g = rasters[t] * self.mask[i]
                self.en[i] = self.en[i] * (1.0 - g) + g
        elif text_dependent:
            mh, mw = h // 2, w // 2
            for i, (y0, x0) in enumerate(boxes):
                g = render_text_raster(self.texts[i], mh, mw)[..., None]
                region = self.en[i, y0:y0 + mh, x0:x0 + mw]
                self.en[i, y0:y0 + mh, x0:x0 + mw] = (
                    region * (1.0 - g) + g)
        self.tokenizer = CharTokenizer(alphabet, cfg.max_text_len)

    def text_batch(self, idx: np.ndarray) -> np.ndarray:
        if self.cfg.text_encoder == "sbert":
            out = np.zeros((len(idx), self.cfg.sbert_dim), np.float32)
            for row, i in enumerate(idx):
                r = np.random.default_rng(abs(hash(self.texts[i])) % (2**32))
                out[row] = r.normal(0, 1, self.cfg.sbert_dim)
            return out
        return self.tokenizer.encode([self.texts[i] for i in idx])

    def batch(self, batch_size: int, step: int = 0) -> dict:
        idx = (np.arange(batch_size) + step * batch_size) % self.num_samples
        return {
            "ru": self.ru[idx],
            "en": self.en[idx],
            "mask": self.mask[idx],
            "text": self.text_batch(idx),
            "raw_text": [self.texts[i] for i in idx],
        }
