"""The serving artifact: the eval-mode generator as a ``torch.export``
program, served without the model code (the JAX package's
``serve/export.py``, with ``torch.export`` in place of ``jax.export``).

An artifact is a directory:

    generator.pt2    the ``torch.export`` program with its weights
                     (``torch.export.save``)
    manifest.json    the JAX manifest's keys: batch size, patch size, the
                     text input's shape and type and how to make it, with
                     ``torch_version`` for ``jax_version`` and ``device``
                     for ``platforms``

The program is ``(ru, mask, text, eps) -> en`` at one batch size, on the
device it was exported on. The GRU recurrence is one node of it, the
port's custom op (``ops/gru.py``: the kernel on the card, the plain loop on
the CPU), and so is each FiLM text-map resize of an artifact exported on
the card (``ops/resize.py``); loading an artifact imports those two modules
to register the ops, and the tokenizer and text embedder, and nothing of
``models/`` or ``train/``. ``ExportedGenerator.generate`` cuts a request
into padded chunks with the noise of ``InferenceEngine.generate``
(``serve/chunks.py``), so artifact and engine give the same patches for one
seed. The switches
that keep float32 work in true float32 on the card (TF32 off,
``ops/precision.py``) are process-wide and not part of a traced program:
the artifact sets them around each call, as the generator's own forward
does in float32.

Usage::

    python -m vae_gan_mark_tpu_torch.serve.export --variant v2 \\
        --workdir ./checkpoints --out ./v2_serving_artifact [--device cpu]

    from vae_gan_mark_tpu_torch.serve.export import ExportedGenerator
    gen = ExportedGenerator.load("./v2_serving_artifact")
    patches = gen.generate(ru, mask, ["NEW TEXT", ...], seed=0)

Export runs on the card unless the caller asks for the CPU; an artifact
exported on the card is served on the card.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vae_gan_mark_tpu_torch.ops.precision import precision_scope
from vae_gan_mark_tpu_torch.serve.chunks import generate_in_chunks

EXPORT_NAME = "generator.pt2"
MANIFEST_NAME = "manifest.json"
CALL_SIGNATURE = "(ru, mask, text, eps) -> en"


def text_spec(cfg, batch_size: int) -> Tuple[Tuple[int, ...], str]:
    """The text input's shape and type: sentence embeddings for the sbert
    text path, else int64 char tokens."""
    if cfg.text_encoder == "sbert":
        return (batch_size, cfg.sbert_dim), "float32"
    return (batch_size, cfg.max_text_len), "int64"


class _Serving(nn.Module):
    """The generator's reconstruction alone, from explicit noise."""

    def __init__(self, generator: nn.Module):
        super().__init__()
        self.generator = generator

    def forward(self, ru, mask, text, eps):
        return self.generator(ru, mask, text, eps=eps)[0]


def _card_check(device: torch.device, what: str) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device}: no CUDA device is "
                           "available; pass device='cpu' to use the CPU")


def export_generator(cfg, generator: nn.Module, out_dir: str,
                     batch_size: int = 16,
                     device: Union[str, torch.device] = "cuda") -> str:
    """Export ``generator`` (a ``VAEGANGenerator`` of ``cfg``, copied and
    put in eval mode on ``device``) at ``batch_size`` into ``out_dir``;
    returns ``out_dir``."""
    device = torch.device(device)
    _card_check(device, "export_generator")
    model = copy.deepcopy(generator).to(device).eval()
    text_shape, text_dtype = text_spec(cfg, batch_size)
    image = (batch_size, cfg.patch_h, cfg.patch_w)
    args = (torch.zeros(image + (3,), device=device),
            torch.zeros(image + (1,), device=device),
            torch.zeros(text_shape, dtype=getattr(torch, text_dtype),
                        device=device),
            torch.zeros((batch_size, 1, 1, cfg.z_ch), device=device))
    with torch.no_grad():
        program = torch.export.export(_Serving(model), args)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, EXPORT_NAME))
    manifest = {
        "variant": cfg.name,
        "batch_size": batch_size,
        "patch_h": cfg.patch_h,
        "patch_w": cfg.patch_w,
        "text_encoder": cfg.text_encoder,
        "text_shape": list(text_shape),
        "text_dtype": text_dtype,
        "alphabet": cfg.alphabet,
        "max_text_len": cfg.max_text_len,
        "sbert_dim": cfg.sbert_dim,
        "device": device.type,
        "torch_version": torch.__version__,
        "call_signature": CALL_SIGNATURE,
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ExportedGenerator:
    """An artifact loaded for serving, without the model code.

    ``generate`` serves any request size in chunks of the artifact's batch
    size, as ``InferenceEngine.generate`` does; ``call`` runs one chunk.
    An sbert artifact needs ``text_embed_fn`` (texts -> (N, sbert_dim)):
    it refuses to make pseudo-embeddings, since a generator trained on
    sentence embeddings gives garbage on them."""

    def __init__(self, program, manifest: dict,
                 text_embed_fn: Optional[Callable] = None):
        self.program = program
        self.module = program.module()
        self.manifest = manifest
        self.batch_size = int(manifest["batch_size"])
        self.device = torch.device(manifest["device"])
        self.text_embed_fn = text_embed_fn
        eps = next(n for n in program.graph.nodes
                   if n.op == "placeholder" and n.name == "eps")
        self.z_ch = int(eps.meta["val"].shape[-1])
        self._tokenizer = None
        if manifest["text_encoder"] != "sbert":
            from vae_gan_mark_tpu_torch.data.tokenizer import CharTokenizer
            self._tokenizer = CharTokenizer(manifest["alphabet"],
                                            int(manifest["max_text_len"]))

    @classmethod
    def load(cls, art_dir: str,
             text_embed_fn: Optional[Callable] = None) -> "ExportedGenerator":
        # Registers the GRU and resize ops the program calls.
        import vae_gan_mark_tpu_torch.ops.gru  # noqa: F401
        import vae_gan_mark_tpu_torch.ops.resize  # noqa: F401
        with open(os.path.join(art_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        _card_check(torch.device(manifest["device"]),
                    "ExportedGenerator.load")
        program = torch.export.load(os.path.join(art_dir, EXPORT_NAME))
        return cls(program, manifest, text_embed_fn)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        if self.manifest["text_encoder"] == "sbert":
            if self.text_embed_fn is None:
                raise RuntimeError(
                    "this artifact was trained with SBERT text embeddings; "
                    "pass text_embed_fn (see data/text_embed.py): refusing "
                    "to substitute pseudo-embeddings")
            return np.asarray(self.text_embed_fn(list(texts)), np.float32)
        return self._tokenizer.encode(texts)

    @torch.no_grad()
    def call(self, ru: np.ndarray, mask: np.ndarray, text: np.ndarray,
             eps) -> np.ndarray:
        """One chunk: (B, H, W, 3), (B, H, W, 1), text, eps (B, 1, 1, z)
        -> (B, H, W, 3) float32, B the artifact's batch size."""
        dtype = getattr(torch, self.manifest["text_dtype"])
        with precision_scope(torch.float32):
            out = self.module(
                torch.tensor(np.asarray(ru, np.float32), device=self.device),
                torch.tensor(np.asarray(mask, np.float32),
                             device=self.device),
                torch.as_tensor(np.asarray(text)).to(self.device, dtype),
                torch.as_tensor(eps, dtype=torch.float32).to(self.device))
        return out.cpu().numpy()

    def generate(self, ru: np.ndarray, mask: np.ndarray,
                 texts: Sequence[str], seed: int = 0) -> np.ndarray:
        """ru (N, H, W, 3), mask (N, H, W, 1) in [0, 1] -> (N, H, W, 3)
        float32 patches; the noise of ``InferenceEngine(seed=seed)``."""
        return generate_in_chunks(self.call, self.encode_texts, ru, mask,
                                  texts, self.batch_size, seed, self.z_ch)


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    from vae_gan_mark_tpu_torch.cli import add_device_flag, parse_overrides
    from vae_gan_mark_tpu_torch.config import (
        VARIANTS, VariantConfig, get_config)
    from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator
    from vae_gan_mark_tpu_torch.train.checkpoint import load_state_file

    p = argparse.ArgumentParser(
        prog="python -m vae_gan_mark_tpu_torch.serve.export",
        description="Export a trained checkpoint's generator as a "
                    "torch.export serving artifact")
    p.add_argument("--variant", choices=sorted(VARIANTS), default="v2")
    p.add_argument("--workdir", required=True)
    p.add_argument("--checkpoint", default="best_model",
                   choices=("best_model", "last_checkpoint"))
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    add_device_flag(p)
    args = p.parse_args(argv)

    cfg = get_config(args.variant, **parse_overrides(VariantConfig, args.set))
    saved = load_state_file(args.workdir, args.checkpoint, mmap=True)
    if saved is None:
        raise SystemExit(f"no checkpoint {args.checkpoint} in "
                         f"{args.workdir}")
    generator = VAEGANGenerator(cfg)
    generator.load_state_dict(saved["generator"])
    out = export_generator(cfg, generator, args.out,
                           batch_size=args.batch_size, device=args.device)
    size = os.path.getsize(os.path.join(out, EXPORT_NAME))
    print(f"exported {args.variant}/{args.checkpoint} -> {out} "
          f"({EXPORT_NAME}: {size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
