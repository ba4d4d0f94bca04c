"""Character text encoders: PAD-masked embedding -> 2-layer BiGRU -> adaptive
pool to W/16 columns (``CharTextEncoder``, v2 and unet); oldv's
``CharTextEncoderPosEnc`` adds a Conv1d over the sequence, a broadcast to a
map of height 4 and a learnable positional encoding.

Submodule names follow the reference's state-dict keys (``embedding``,
``rnn.weight_ih_l0`` ..., ``conv1d.weight``, ``pos_enc``). Tokenisation
happens on the host (``data/tokenizer.py``); the modules take int token ids.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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

    def embed_and_encode(self, tokens: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        # Multiplying by the PAD mask pins row 0 to zero, as
        # nn.Embedding(padding_idx=0) does in the reference.
        emb = self.embedding(tokens) * (tokens != 0)[..., None].float()
        return self.rnn(emb, generator)


class CharTextEncoder(_CharEmbedGRU):
    """tokens (B, L) -> spatial text features (B, 2H, 1, out_width), the
    NCHW form of the JAX package's (B, 1, out_width, 2H). ``generator``
    draws the BiGRU's train-mode dropout."""

    def __init__(self, vocab_size: int, out_width: int, emb_dim: int = 128,
                 rnn_hidden: int = 256, rnn_layers: int = 2,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, emb_dim, rnn_hidden, rnn_layers,
                         dropout, dtype)
        self.out_width = out_width

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.embed_and_encode(tokens, generator)       # (B, L, 2H)
        y = adaptive_avg_pool1d(y, self.out_width)         # (B, W_t, 2H)
        return y.transpose(1, 2)[:, :, None, :]            # (B, 2H, 1, W_t)


class CharTextEncoderPosEnc(_CharEmbedGRU):
    """oldv: tokens (B, L) -> (B, 2H, out_height, out_width), the NCHW form
    of the JAX package's (B, out_height, out_width, 2H). The BiGRU's outputs
    go through ``conv1d`` (2H -> 2H, k 3, padding 1) over the sequence in
    ``dtype``, are pooled to ``out_width`` columns, broadcast to
    ``out_height`` rows, and ``pos_enc`` (1, 2H, out_height, out_width),
    initialised to 0.02 * N(0, 1), is added."""

    def __init__(self, vocab_size: int, out_width: int, emb_dim: int = 128,
                 rnn_hidden: int = 256, rnn_layers: int = 2,
                 dropout: float = 0.1, out_height: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, emb_dim, rnn_hidden, rnn_layers,
                         dropout, dtype)
        ch = 2 * rnn_hidden
        self.out_width = out_width
        self.out_height = out_height
        self.dtype = dtype
        self.conv1d = nn.Conv1d(ch, ch, 3, padding=1)
        self.pos_enc = nn.Parameter(
            0.02 * torch.randn(1, ch, out_height, out_width))

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        y = self.embed_and_encode(tokens, generator)       # (B, L, 2H)
        y = F.conv1d(y.transpose(1, 2).to(dt), self.conv1d.weight.to(dt),
                     self.conv1d.bias.to(dt), padding=1)   # (B, 2H, L)
        y = adaptive_avg_pool1d(y.transpose(1, 2), self.out_width)
        y = y.transpose(1, 2)[:, :, None, :]               # (B, 2H, 1, W_t)
        y = y.expand(-1, -1, self.out_height, -1)
        return y + self.pos_enc.to(y.dtype)
