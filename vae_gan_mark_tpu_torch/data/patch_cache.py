"""Persistent cache of decoded patches: decode and warp each sample once,
then stream it from a memmap (the JAX package's ``data/patch_cache.py``).

``load_sample`` is deterministic and the dataset static, so later epochs
need not decode the same pixels again. ``PatchCache`` keeps one uint8 row
per sample (ru RGB + en RGB + mask, packed (H, W, 7)) and its text: char
tokens, or for the sbert text path its float32 embedding (text mode
``sbert384``; ``text_embed_fn``, else ``hash_embed``).
Rows fill at first access (or all at once with ``prewarm``). A fingerprint
of the index (paths, boxes, texts, file sizes and times) and the patch
geometry clears the cache when either changes. A sample that fails to load
caches the zero row and empty text that ``load_sample`` gives.

Prewarm from the command line:

    python -m vae_gan_mark_tpu_torch.data.patch_cache --variant v2 \
        --json-dir ... --ru-dir ... --en-dir ... --mask-dir ... \
        --cache-dir ./patch_cache

For vanilla and lr_sh it embeds the texts with the cached SBERT model and
refuses without one, unless ``--allow-hash-embed`` accepts ``hash_embed``.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data.index import Sample
from vae_gan_mark_tpu_torch.data.text_embed import encode_texts
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer

_CHANNELS = 7  # ru RGB | en RGB | mask


def _stat_sig(path) -> tuple:
    try:
        st = os.stat(path)
        return (int(st.st_size), int(st.st_mtime))
    except OSError:
        return (0, 0)


def dataset_fingerprint(cfg: VariantConfig,
                        samples: Sequence[Sample],
                        text_mode: str) -> str:
    h = hashlib.sha256()
    h.update(json.dumps([cfg.patch_h, cfg.patch_w, text_mode,
                         len(samples)]).encode())
    for s in samples:
        h.update(json.dumps([
            s.ru_image_path, s.en_image_path, s.mask_path,
            list(map(float, np.ravel(s.bbox_ru))),
            list(map(float, np.ravel(s.bbox_en))) if s.bbox_en else None,
            s.text,
            _stat_sig(s.ru_image_path),
            _stat_sig(s.en_image_path) if s.en_image_path else None,
        ], ensure_ascii=False).encode())
    return h.hexdigest()


class PatchCache:
    """Memmap cache over the whole sample list (the train and val loaders
    read disjoint rows of the same arrays); char tokens as int32
    (N, max_text_len), or sbert embeddings as float32 (N, sbert_dim)."""

    def __init__(self, cache_dir: str, cfg: VariantConfig,
                 samples: Sequence[Sample],
                 text_embed_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.samples = samples
        self.tokenizer = CharTokenizer(cfg.alphabet, cfg.max_text_len)
        self.text_embed_fn = text_embed_fn
        n = len(samples)
        h, w = cfg.patch_h, cfg.patch_w
        if cfg.text_encoder == "sbert":
            text_mode = f"sbert{cfg.sbert_dim}"
            text_shape, text_dtype = (n, cfg.sbert_dim), np.float32
        else:
            text_mode = f"chars{cfg.max_text_len}"
            text_shape, text_dtype = (n, cfg.max_text_len), np.int32

        os.makedirs(cache_dir, exist_ok=True)
        self.dir = cache_dir
        meta_path = os.path.join(cache_dir, "meta.json")
        fp = dataset_fingerprint(cfg, samples, text_mode)
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fp:
                meta = None  # dataset or geometry changed: rebuild
        if meta is None:
            for name in ("patches.u8", "filled.u8", "ok.u8", "text.bin"):
                p = os.path.join(cache_dir, name)
                if os.path.exists(p):
                    os.remove(p)
            with open(meta_path, "w") as f:
                json.dump({"fingerprint": fp, "n": n, "h": h, "w": w,
                           "text_mode": text_mode}, f)

        def open_memmap(name, dtype, shape):
            path = os.path.join(cache_dir, name)
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            fresh = not (os.path.exists(path)
                         and os.path.getsize(path) == nbytes)
            return np.memmap(path, dtype, "w+" if fresh else "r+",
                             shape=shape)

        self.patches = open_memmap("patches.u8", np.uint8,
                                   (n, h, w, _CHANNELS))
        # filled: 0 = empty, 1 = pixels cached, 2 = pixels + text cached.
        self.filled = open_memmap("filled.u8", np.uint8, (n,))
        # ok: the decode succeeded. A failed row keeps the zero images and
        # the EMPTY text; its index text must not reach the tokens.
        self.ok = open_memmap("ok.u8", np.uint8, (n,))
        self.text = open_memmap("text.bin", text_dtype, text_shape)

    # -- fill ----------------------------------------------------------
    def _fill_pixels(self, idx: int) -> None:
        from vae_gan_mark_tpu_torch.data.pipeline import load_sample
        ru, en, mask, text = load_sample(self.samples[idx], self.cfg)
        row = self.patches[idx]
        # +0.5 before the uint8 truncation gives back the exact source gray
        # levels of the /255.0 floats.
        row[..., 0:3] = (ru * 255.0 + 0.5).astype(np.uint8)
        row[..., 3:6] = (en * 255.0 + 0.5).astype(np.uint8)
        row[..., 6:7] = (mask * 255.0 + 0.5).astype(np.uint8)
        # load_sample signals failure with "" in place of the index text.
        self.ok[idx] = 1 if text == self.samples[idx].text else 0

    def _encode_texts(self, texts: List[str]) -> np.ndarray:
        return encode_texts(self.cfg, self.tokenizer, self.text_embed_fn,
                            texts)

    def ensure(self, indices: Sequence[int], num_workers: int = 8) -> None:
        """Fill any missing rows (threaded decode; texts encoded
        together)."""
        missing = [int(i) for i in indices if self.filled[int(i)] < 1]
        if missing:
            if num_workers > 1:
                with cf.ThreadPoolExecutor(num_workers) as pool:
                    list(pool.map(self._fill_pixels, missing))
            else:
                for i in missing:
                    self._fill_pixels(i)
            self.filled[missing] = 1
        no_text = [int(i) for i in indices if self.filled[int(i)] < 2]
        if no_text:
            enc = self._encode_texts(
                [self._row_text(i) for i in no_text])
            self.text[no_text] = enc
            self.filled[no_text] = 2

    def prewarm(self, indices=None, num_workers: int = 8,
                progress: bool = False) -> None:
        idxs = list(range(len(self.samples))) if indices is None \
            else list(indices)
        chunk = 256
        for start in range(0, len(idxs), chunk):
            self.ensure(idxs[start:start + chunk], num_workers)
            if progress:
                print(f"[patch_cache] {min(start + chunk, len(idxs))}"
                      f"/{len(idxs)}", flush=True)
        self.flush()

    def flush(self) -> None:
        self.patches.flush()
        self.text.flush()
        self.ok.flush()
        self.filled.flush()

    # -- read ----------------------------------------------------------
    def batch(self, indices: Sequence[int], num_workers: int = 8) -> dict:
        """A batch {ru, en, mask, text, raw_text} of rows ``indices``,
        filling misses first."""
        idxs = [int(i) for i in indices]
        self.ensure(idxs, num_workers)
        rows = self.patches[idxs]  # one uint8 gather from the memmap

        def part(sl):  # slice -> contiguous f32 in [0, 1], one copy
            a = rows[..., sl].astype(np.float32)
            a /= np.float32(255.0)  # a true divide: the same bits as /255.0
            return a

        return {"ru": part(slice(0, 3)),
                "en": part(slice(3, 6)),
                "mask": part(slice(6, 7)),
                "text": np.asarray(self.text[idxs]),
                "raw_text": [self._row_text(i) for i in idxs]}

    def _row_text(self, idx: int) -> str:
        return self.samples[idx].text if self.ok[idx] else ""


def main(argv=None):
    """Prewarm the cache of a dataset (see the module docstring)."""
    import argparse
    from vae_gan_mark_tpu_torch.config import VARIANTS, get_config
    from vae_gan_mark_tpu_torch.data.index import build_index

    p = argparse.ArgumentParser(prog="vae_gan_mark_tpu_torch.data.patch_cache",
                                description=main.__doc__)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--json-dir", required=True)
    p.add_argument("--ru-dir", required=True)
    p.add_argument("--en-dir", required=True)
    p.add_argument("--mask-dir", required=True)
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--allow-hash-embed", action="store_true",
                   help="sbert variants: cache hash_embed pseudo-embeddings "
                        "when the SBERT model is not cached locally")
    args = p.parse_args(argv)

    cfg = get_config(args.variant)
    samples = build_index(args.json_dir, args.ru_dir, args.en_dir,
                          args.mask_dir)
    text_embed_fn = None
    if cfg.text_encoder == "sbert":
        from vae_gan_mark_tpu_torch.data.text_embed import make_text_embedder
        text_embed_fn = make_text_embedder(
            require_sbert=not args.allow_hash_embed)
    cache = PatchCache(args.cache_dir, cfg, samples,
                       text_embed_fn=text_embed_fn)
    cache.prewarm(num_workers=args.num_workers, progress=True)
    print(f"[patch_cache] {len(samples)} samples cached in {args.cache_dir}")


if __name__ == "__main__":
    main()
