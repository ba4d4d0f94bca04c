"""Plain reference of serving: the generator in eval mode (BatchNorm on its
running statistics) over a request's rows, with the noise that the serving
contract gives each row.

The contract: a request of N rows is served in chunks of ``batch_size``
rows starting at rows 0, batch_size, ...; the chunk at ``start`` takes its
noise from a CPU ``torch.Generator`` seeded from ``chunk_seed(seed,
start)``, one N(0, 1) draw of shape (batch_size, 1, 1, z_ch), row i of the
chunk taking row i. In eval mode every row is computed on its own, so the
reference runs the real rows alone, in blocks of at most ``batch_size``.
Texts come as the generator's reference module makes them
(``text_inputs``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def chunk_seed(seed: int, start: int) -> int:
    state = np.random.SeedSequence([seed, start]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_noise(seed: int, start: int, batch_size: int,
                z_ch: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(chunk_seed(seed, start))
    return torch.randn((batch_size, 1, 1, z_ch), generator=gen,
                       dtype=torch.float32)


@torch.no_grad()
def serve_rows(g: nn.Module, cfg: dict, ru: np.ndarray, mask: np.ndarray,
               text: torch.Tensor, seed: int, batch_size: int,
               device) -> np.ndarray:
    """The (N, H, W, 3) patches of one request; ``text`` holds its N rows'
    text inputs."""
    g.eval()
    outs = []
    for start in range(0, ru.shape[0], batch_size):
        end = min(start + batch_size, ru.shape[0])
        eps = chunk_noise(seed, start, batch_size, cfg["z_ch"])[:end - start]

        def put(a):
            return torch.as_tensor(a[start:end]).to(device)
        recon, _, _ = g(put(ru).float(), put(mask).float(), put(text),
                        eps=eps.permute(0, 3, 1, 2).to(device))
        outs.append(recon.cpu().numpy())
    return np.concatenate(outs)
