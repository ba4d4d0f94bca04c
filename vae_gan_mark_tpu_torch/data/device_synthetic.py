"""Device-resident synthetic data: the whole dataset in GPU memory, each
batch an index gather on the card (the JAX package's
``data/device_synthetic.py``).

A synthetic dataset does not change between epochs, so ``ru``, ``en``,
``mask`` and the text (tokens, or embeddings for the sbert path) go to the
device once, and a batch costs one copy of its int64 row indices and a
gather per array, with no image bytes from the host. Batches and their
order are the same as ``SyntheticPatchDataset.batch`` (rows
``(arange(bs) + step * bs) % n``), bit for bit, so a run checkpointed on
the host path resumes on this one and back.
"""

from __future__ import annotations

from typing import Iterator, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset


class DeviceResidentSynthetic:
    """Data source (``epoch -> iterator of batches``) whose image and token
    tensors are gathered on ``device`` from a copy of the dataset there;
    ``raw_text`` stays a host list. ``device`` defaults to ``"cuda"`` and
    raises when no card is present."""

    def __init__(self, ds: SyntheticPatchDataset, batch_size: int,
                 steps_per_epoch: int, advance_per_epoch: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceResidentSynthetic(device={str(device)!r}): no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        self.ds = ds
        self.batch_size = batch_size
        self.steps = steps_per_epoch
        # Train sources move their batch window on every epoch (batch(bs,
        # i + epoch * steps)); val sources replay the same window
        # (batch(bs, i)).
        self.advance = advance_per_epoch
        text = ds.text_batch(np.arange(ds.num_samples))
        self.data = {
            "ru": torch.from_numpy(ds.ru).to(self.device),
            "en": torch.from_numpy(ds.en).to(self.device),
            "mask": torch.from_numpy(ds.mask).to(self.device),
            "text": as_batch_tensor("text", torch.from_numpy(text)).to(
                self.device),
        }

    def __call__(self, epoch: int) -> Iterator[dict]:
        n = self.ds.num_samples
        bs = self.batch_size
        base = epoch * self.steps if self.advance else 0
        for i in range(self.steps):
            idx = (np.arange(bs) + (base + i) * bs) % n
            rows = torch.from_numpy(idx).to(self.device)
            batch = {k: v.index_select(0, rows) for k, v in self.data.items()}
            batch["raw_text"] = [self.ds.texts[j] for j in idx]
            yield batch

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())
