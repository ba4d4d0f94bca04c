"""Inference engine: fixed-size batches through the generator, and the
full-image path (crop the quad, generate, paste back).

Inputs and outputs are NHWC numpy arrays, as in the JAX package's engine.
Requests of any size go through in chunks of ``batch_size`` with the tail
padded, so the GRU kernel and the convolutions always see one shape
(``serve/chunks.py``, which the exported artifact shares). The
reparameterisation noise of the chunk that starts at request row ``start``
comes from a CPU ``torch.Generator`` seeded from ``(seed, start)`` and is
then moved to the device, so one seed gives the same noise on every device.

``InferenceEngine.from_checkpoint`` serves the generator of a trainer's
checkpoint (``train/checkpoint.py``); ``python -m vae_gan_mark_tpu_torch.serve``
renders one image with it.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.data.text_embed import encode_texts
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer
from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator
from vae_gan_mark_tpu_torch.ops.warp import (
    perspective_crop_batch, perspective_unwarp)
from vae_gan_mark_tpu_torch.serve.chunks import (  # noqa: F401 (chunk_seed)
    chunk_noise, chunk_seed, generate_in_chunks)


class InferenceEngine:
    """Fixed-batch generator serving on one device.

    ``weights`` is a ``VAEGANGenerator`` or its ``state_dict``. ``device``
    defaults to ``"cuda"`` and raises when no card is present: it never runs
    on the CPU unless asked to. ``text_embed_fn`` (texts -> (N, sbert_dim))
    embeds the texts for the sbert text path; without it they go through
    ``hash_embed``.
    """

    def __init__(self, cfg: VariantConfig,
                 weights: Union[VAEGANGenerator, Mapping[str, torch.Tensor]],
                 batch_size: int = 16, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 text_embed_fn: Optional[Callable] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"InferenceEngine(device={str(device)!r}): no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.tokenizer = CharTokenizer(cfg.alphabet, cfg.max_text_len)
        self.text_embed_fn = text_embed_fn
        if isinstance(weights, VAEGANGenerator):
            model = weights
        else:
            model = VAEGANGenerator(cfg)
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, cfg: VariantConfig, workdir: str,
                        name: str = "best_model", batch_size: int = 16,
                        seed: int = 0,
                        device: Union[str, torch.device] = "cuda",
                        text_embed_fn: Optional[Callable] = None
                        ) -> "InferenceEngine":
        """The generator of checkpoint ``workdir/name`` (its BatchNorm
        statistics included); the discriminator and the optimizers in the
        file are not used. ``cfg`` must be the training run's."""
        from vae_gan_mark_tpu_torch.train.checkpoint import load_state_file
        saved = load_state_file(workdir, name, mmap=True)
        if saved is None:
            raise FileNotFoundError(f"no checkpoint {name} in {workdir}")
        return cls(cfg, saved["generator"], batch_size=batch_size, seed=seed,
                   device=device, text_embed_fn=text_embed_fn)

    # ------------------------------------------------------------------
    def _encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """(N, sbert_dim) float32 embeddings for the sbert text path, else
        (N, max_len) int32 tokens."""
        return encode_texts(self.cfg, self.tokenizer, self.text_embed_fn,
                            texts)

    def noise(self, start: int) -> torch.Tensor:
        """The (batch_size, 1, 1, z_ch) float32 noise of the chunk at
        ``start``, on the CPU."""
        return chunk_noise(self.seed, start, self.batch_size, self.cfg.z_ch)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)    # a copy

    @torch.no_grad()
    def generate(self, ru: np.ndarray, mask: np.ndarray,
                 texts: Sequence[str]) -> np.ndarray:
        """ru (N, H, W, 3), mask (N, H, W, 1) float in [0, 1]; returns the
        (N, H, W, 3) float32 patches."""
        return generate_in_chunks(self._run_chunk, self._encode_texts, ru,
                                  mask, texts, self.batch_size, self.seed,
                                  self.cfg.z_ch)

    def _run_chunk(self, ru: np.ndarray, mask: np.ndarray, text: np.ndarray,
                   eps: torch.Tensor) -> np.ndarray:
        recon, _, _ = self.model(
            self._to_device(ru), self._to_device(mask),
            as_batch_tensor("text", self._to_device(text)),
            eps=eps.to(self.device))
        return recon.cpu().numpy()

    @torch.no_grad()
    def render(self, image: np.ndarray, mask_image: np.ndarray,
               quad: np.ndarray, text: str) -> np.ndarray:
        """Full-image path: crop quad -> generate -> paste back. A uint8
        image or mask is scaled to [0, 1] first."""
        cfg = self.cfg
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        msk = np.asarray(mask_image)
        if msk.dtype == np.uint8:
            msk = msk.astype(np.float32) / 255.0
        if msk.ndim == 2:
            msk = msk[..., None]
        img_t = self._to_device(img)
        quad_t = self._to_device(np.asarray(quad, np.float32))
        ru = perspective_crop_batch(img_t[None], quad_t[None],
                                    cfg.patch_h, cfg.patch_w)
        mk = perspective_crop_batch(self._to_device(msk)[None], quad_t[None],
                                    cfg.patch_h, cfg.patch_w)
        patch = self.generate(ru.cpu().numpy(), mk.cpu().numpy(), [text])[0]
        out = perspective_unwarp(self._to_device(patch), quad_t, img_t,
                                 img.shape[0], img.shape[1])
        return out.cpu().numpy()
