"""CUDA-graph replay of a step: the port's counterpart of the JAX package's
``multi_step``, which runs K steps in one dispatch with ``lax.scan``
(``train/step.py:build_multi_train_step``). A train step is some 3,000
kernel launches whose dispatch costs more host time than the card needs
for them at batch 16; a replay of a captured graph costs one call.

The design: ONE step is captured and replayed K times, not K steps as one
graph. A K-step graph would need K input slots and K generators, its
capture would run K steps' Python, and it would hold K steps' activations;
a replay a step already removes the dispatch cost (about ten launches a
step stay: the input copies, the reseed, the KL weight, the metric sums).

``CapturedStep(fn, batch)`` captures ``fn(inputs, generator, kl_weight)``:

* ``inputs``: static copies of ``batch`` (``ru``, ``en``, ``mask``,
  ``text``, and ``eps`` when given); a replay first copies the next
  batch's tensors into them, device to device. A batch of another
  signature (a short last batch) does not fit the graph.
* ``generator``: a ``torch.Generator`` registered with the graph
  (``CUDAGraph.register_generator_state``) and reseeded before each
  replay, so a replay draws the noise and dropout masks that an eager step
  draws from a fresh generator of that seed.
* ``kl_weight``: a float32 0-d tensor filled before each replay (it
  changes every epoch under KL annealing).
* ``outputs``: what ``fn`` returned during capture; each replay overwrites
  them, so a caller reads them before the next replay.

Capture runs ``fn``'s Python once and executes nothing on the card, so host
state that ``fn`` moves is put back: the kernels' launch counts here, the
train state's step count by the caller. Each replay adds what the capture
launched to the counts (``ops/cuda_build.py:add_launches``). The capture
is ``thread_local``: the prefetch thread may copy and gather on the card
meanwhile. A failed capture or replay raises; nothing falls back to eager
steps.

Before a capture a step of the same kind and batch signature must have run
eagerly on that device in this process (``mark_warm`` / ``is_warm``): that
run builds what a capture cannot (cuBLAS and cuDNN handles, the ops' device
constants, the kernels' first-launch host work).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Mapping, Set, Tuple

import torch

from vae_gan_mark_tpu_torch.ops.cuda_build import add_launches, launch_counts

Batch = Mapping[str, torch.Tensor]
Signature = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]

_WARM: Set[Tuple[Hashable, torch.device, Signature]] = set()


def batch_signature(batch: Batch) -> Signature:
    """The keys, shapes and dtypes of a batch: what a graph is fixed to."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


def mark_warm(kind: Hashable, batch: Batch) -> None:
    """A ``kind`` step ran eagerly on ``batch``'s device and signature."""
    _WARM.add((kind, batch["ru"].device, batch_signature(batch)))


def is_warm(kind: Hashable, batch: Batch) -> bool:
    return (kind, batch["ru"].device, batch_signature(batch)) in _WARM


class CapturedStep:
    """One call of ``fn(inputs, generator, kl_weight)`` captured as a CUDA
    graph on ``batch``'s device; ``replay`` runs it on another batch."""

    def __init__(self, fn: Callable, batch: Batch):
        device = batch["ru"].device
        self.signature = batch_signature(batch)
        self.inputs: Dict[str, torch.Tensor] = {
            k: v.clone() for k, v in batch.items()}
        self.generator = torch.Generator(device=device)
        self.kl_weight = torch.zeros((), dtype=torch.float32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(self.inputs, self.generator,
                                  self.kl_weight)
        finally:
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in before})
        self.launches = {k: after[k] - before[k] for k in before
                         if after[k] != before[k]}

    def fits(self, batch: Batch) -> bool:
        return batch_signature(batch) == self.signature

    def replay(self, batch: Batch, seed: int, kl_weight: float):
        """Copy ``batch`` into the inputs, seed the generator, set the KL
        weight, replay; returns the outputs (overwritten by the next
        replay)."""
        if not self.fits(batch):
            raise ValueError(f"a batch of signature {batch_signature(batch)}"
                             f" does not fit a graph of {self.signature}")
        for key, static in self.inputs.items():
            static.copy_(batch[key])
        self.generator.manual_seed(seed)
        self.kl_weight.fill_(kl_weight)
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs
