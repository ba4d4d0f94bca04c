"""Host-side data helpers."""

import torch


def as_batch_tensor(key: str, value: torch.Tensor) -> torch.Tensor:
    """A batch entry in the dtype the steps take: ``text`` int64 when it
    holds tokens, float32 when it holds sentence embeddings (the sbert
    text path); the images, masks and noise float32."""
    if key == "text" and not value.is_floating_point():
        return value.long()
    return value.float()
