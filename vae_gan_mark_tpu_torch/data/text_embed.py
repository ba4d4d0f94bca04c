"""Sentence embeddings for the sbert text path (vanilla, lr_sh), made on the
host: the port's own copy of the JAX package's ``data/text_embed.py``.

The reference embeds texts with a frozen MiniLM sentence transformer; only
the 384 -> 64 projection trains (``models/text_encoders.py:
SbertProjector``). Here the embeddings are inputs of the step:

* ``SbertEmbedder`` wraps sentence-transformers when the model is cached
  locally. It never downloads: a missing package or model raises, and
  callers fall back or refuse;
* ``hash_embed`` is the offline fallback: a deterministic pseudo-embedding
  keyed by the text's SHA-256 (distinct texts give distinct vectors, equal
  texts equal ones), the same values as the JAX package's for the same text.
"""

from __future__ import annotations

import hashlib
import sys
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

SBERT_MODEL_NAME = (
    "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2")


def hash_embed(texts: Iterable[str], dim: int = 384) -> np.ndarray:
    """(len(texts), dim) float32 normal vectors, one seed per text."""
    out = []
    for text in texts:
        digest = hashlib.sha256(text.encode("utf-8")).digest()
        seed = int.from_bytes(digest[:8], "little") % (2 ** 32)
        out.append(np.random.default_rng(seed).normal(0, 1, dim))
    return np.asarray(out, np.float32)


def encode_texts(cfg, tokenizer, text_embed_fn: Optional[Callable],
                 texts: Sequence[str]) -> np.ndarray:
    """A batch's ``text`` for ``cfg``: (B, sbert_dim) float32 embeddings
    for the sbert text path (``text_embed_fn``, else ``hash_embed``),
    otherwise ``tokenizer``'s int32 char tokens."""
    if cfg.text_encoder == "sbert":
        if text_embed_fn is None:
            return hash_embed(texts, cfg.sbert_dim)
        return np.asarray(text_embed_fn(list(texts)), np.float32)
    return tokenizer.encode(texts)


class SbertEmbedder:
    """MiniLM embeddings from a locally cached model (no download)."""

    def __init__(self, model_name: str = SBERT_MODEL_NAME,
                 device: str = "cpu"):
        from sentence_transformers import SentenceTransformer
        self.model = SentenceTransformer(model_name, device=device,
                                         local_files_only=True)
        self.dim = self.model.get_sentence_embedding_dimension()

    def __call__(self, texts: List[str]) -> np.ndarray:
        return np.asarray(
            self.model.encode(list(texts), convert_to_numpy=True),
            np.float32)


def make_text_embedder(prefer_sbert: bool = True,
                       require_sbert: bool = False):
    """The best embedder there is: SBERT if cached locally, else
    ``hash_embed`` with a warning on stderr.

    ``require_sbert=True`` raises ``RuntimeError`` instead of falling back:
    a checkpoint trained on real embeddings served or evaluated on
    pseudo-embeddings gives garbage (the serve and eval CLIs pass it unless
    ``--allow-hash-embed`` is given).
    """
    if prefer_sbert:
        try:
            return SbertEmbedder()
        except Exception as e:
            if require_sbert:
                raise RuntimeError(
                    f"SBERT model '{SBERT_MODEL_NAME}' is unavailable "
                    f"({type(e).__name__}: {e}). Refusing to fall back to "
                    f"hash_embed: an sbert-variant checkpoint served on "
                    f"pseudo-embeddings generates garbage. Cache the "
                    f"sentence-transformers model locally, or pass "
                    f"--allow-hash-embed to accept the fallback "
                    f"explicitly.") from e
            print(f"[text_embed] WARNING: SBERT unavailable "
                  f"({type(e).__name__}); using deterministic hash_embed "
                  f"fallback", file=sys.stderr)
    return lambda texts: hash_embed(texts)
