"""Host-side character tokenizer (a copy of the JAX package's).

Chars map to ``alphabet.index + 1``, PAD=0, out-of-vocabulary -> PAD,
truncate then right-pad to ``max_len``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class CharTokenizer:
    def __init__(self, alphabet: str, max_len: int = 60):
        self.alphabet = alphabet
        self.max_len = max_len
        self.char_to_idx = {ch: i + 1 for i, ch in enumerate(alphabet)}
        self.pad_idx = 0
        self.vocab_size = len(alphabet) + 1

    def encode(self, texts: Iterable[str]) -> np.ndarray:
        texts = list(texts)
        out = np.zeros((len(texts), self.max_len), dtype=np.int32)
        for row, text in enumerate(texts):
            for col, ch in enumerate(text[:self.max_len]):
                out[row, col] = self.char_to_idx.get(ch, self.pad_idx)
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        inv = {v: k for k, v in self.char_to_idx.items()}
        return "".join(inv.get(int(t), "") for t in tokens if int(t) != 0)
