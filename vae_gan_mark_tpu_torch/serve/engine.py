"""Inference engine: fixed-size batches through the generator, and the
full-image path (crop the quad, generate, paste back).

Inputs and outputs are NHWC numpy arrays, as in the JAX package's engine.
Requests of any size go through in chunks of ``batch_size`` with the tail
padded, so the GRU kernel and the convolutions always see one shape
(``serve/chunks.py``, which the exported artifact shares). The
reparameterisation noise of the chunk that starts at request row ``start``
comes from a CPU ``torch.Generator`` seeded from ``(seed, start)`` and is
then moved to the device, so one seed gives the same noise on every device.

A call of ``generate`` is a ``serve.request`` span (``utils/profiling.py``);
inside it each chunk's copies to the device, the generator's forward and
the copy back are the spans ``serve.copy_in``, ``serve.forward`` and
``serve.copy_out``, beside ``serve/chunks.py``'s.

On a CUDA device the generator's forward is replayed as a CUDA graph, as
``train/graphs.py:Replayer`` decides: an engine's first chunk of a batch
signature runs eagerly, its second is captured, and every later chunk
copies its host arrays into the graph's inputs (in ``serve.copy_in``) and
replays it (in ``serve.forward``). A replay's output is read back to the
host before the next chunk runs, and one lock serialises the chunks, so
threads that share an engine never interleave on the graph's buffers. A
chunk runs with the engine's card as the current device, so that the
capture records the launches of an engine on any card. On the CPU every
chunk runs eagerly, without the lock. The ``serve.forward`` span's
``kind`` is ``eager``, ``capture`` or ``replay``; the counters
``serve.forwards_eager`` and ``serve.forwards_replayed`` count the chunks,
``serve.graph_captures`` the captures.

``InferenceEngine.from_checkpoint`` serves the generator of a trainer's
checkpoint (``train/checkpoint.py``); ``python -m vae_gan_mark_tpu_torch.serve``
renders one image with it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vae_gan_mark_tpu_torch.config import VariantConfig
from vae_gan_mark_tpu_torch.data import as_batch_tensor
from vae_gan_mark_tpu_torch.data.text_embed import encode_texts
from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer
from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator
from vae_gan_mark_tpu_torch.ops.warp import (
    perspective_crop_batch, perspective_unwarp)
from vae_gan_mark_tpu_torch.serve.chunks import chunk_noise, generate_in_chunks
from vae_gan_mark_tpu_torch.train.graphs import Replayer
from vae_gan_mark_tpu_torch.utils.profiling import count, span

Batch = Dict[str, torch.Tensor]


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """``arr`` as a CPU tensor, sharing its memory where numpy allows: a
    copy would cost a fresh host buffer a chunk, whose page faults and
    unmapping the host pays on every request."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


class InferenceEngine:
    """Fixed-batch generator serving on one device.

    ``weights`` is a ``VAEGANGenerator`` or its ``state_dict``. ``device``
    defaults to ``"cuda"`` and raises when no card is present: it never runs
    on the CPU unless asked to. ``text_embed_fn`` (texts -> (N, sbert_dim))
    embeds the texts for the sbert text path; without it they go through
    ``hash_embed``.

    On a CUDA device the forward is replayed as a CUDA graph (the module's
    docstring). One lock serialises the chunks of all threads, each run
    with the engine's card as the current device.
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
        self._replayer = Replayer(cfg, "serve.graph_captures",
                                  "the generator's forward")
        self._lock = threading.Lock()

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
        with span("serve.request", rows=int(ru.shape[0])):
            return generate_in_chunks(self._run_chunk, self._encode_texts,
                                      ru, mask, texts, self.batch_size,
                                      self.seed, self.cfg.z_ch)

    def _forward(self, batch: Batch) -> torch.Tensor:
        recon, _, _ = self.model(batch["ru"], batch["mask"], batch["text"],
                                 eps=batch["eps"])
        return recon

    @contextlib.contextmanager
    def _on_card(self) -> Iterator[None]:
        """One chunk at a time, with the engine's card as the current
        device; nothing on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        with self._lock, torch.cuda.device(self.device):
            yield

    def _run_chunk(self, ru: np.ndarray, mask: np.ndarray, text: np.ndarray,
                   eps: torch.Tensor) -> np.ndarray:
        with self._on_card():
            with span("serve.copy_in"):
                host = {"ru": _host_tensor(ru), "mask": _host_tensor(mask),
                        "text": as_batch_tensor("text", _host_tensor(text)),
                        "eps": eps}
                batch = self._replayer.load(host)
                if batch is None:
                    batch = {k: v.to(self.device) for k, v in host.items()}
            with span("serve.forward") as sp:
                graph, kind = self._replayer.get(
                    batch, lambda inputs, generator, kl: self._forward(inputs))
                sp.set(kind=kind)
                if graph is None:
                    count("serve.forwards_eager")
                    recon = self._forward(batch)
                    self._replayer.note_eager(batch)
                else:
                    count("serve.forwards_replayed")
                    recon = graph.run()
            with span("serve.copy_out"):
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
