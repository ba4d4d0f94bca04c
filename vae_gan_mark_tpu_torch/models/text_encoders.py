"""Character text encoder: PAD-masked embedding -> 2-layer BiGRU -> adaptive
pool to W/16 columns.

Submodule names follow the reference's state-dict keys (``embedding``,
``rnn.weight_ih_l0`` ...). Tokenisation happens on the host
(``data/tokenizer.py``); the modules take int token ids.
"""

from __future__ import annotations

import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.pool import adaptive_avg_pool1d
from vae_gan_mark_tpu_torch.ops.rnn import BiGRU


class _CharEmbedGRU(nn.Module):
    """Shared front end: PAD-masked char embedding -> BiGRU outputs
    (B, L, 2H) in ``dtype``."""

    def __init__(self, vocab_size: int, emb_dim: int = 128,
                 rnn_hidden: int = 256, rnn_layers: int = 2,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, emb_dim)
        self.rnn = BiGRU(emb_dim, rnn_hidden, rnn_layers, dropout, dtype)

    def embed_and_encode(self, tokens: torch.Tensor) -> torch.Tensor:
        # Multiplying by the PAD mask pins row 0 to zero, as
        # nn.Embedding(padding_idx=0) does in the reference.
        emb = self.embedding(tokens) * (tokens != 0)[..., None].float()
        return self.rnn(emb)


class CharTextEncoder(_CharEmbedGRU):
    """tokens (B, L) -> spatial text features (B, 2H, 1, out_width), the
    NCHW form of the JAX package's (B, 1, out_width, 2H)."""

    def __init__(self, vocab_size: int, out_width: int, emb_dim: int = 128,
                 rnn_hidden: int = 256, rnn_layers: int = 2,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, emb_dim, rnn_hidden, rnn_layers,
                         dropout, dtype)
        self.out_width = out_width

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        y = self.embed_and_encode(tokens)                  # (B, L, 2H)
        y = adaptive_avg_pool1d(y, self.out_width)         # (B, W_t, 2H)
        return y.transpose(1, 2)[:, :, None, :]            # (B, 2H, 1, W_t)
