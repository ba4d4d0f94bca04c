"""CUDA-graph replay of a step, and the one policy of when a step is
captured and replayed, for the multi steps (``train/step.py``, the port's
counterpart of the JAX package's ``lax.scan`` multi step) and the serving
engine (``serve/engine.py``). A train step is some 3,000 kernel launches
whose dispatch costs more host time than the card needs for them at batch
16; a replay of a captured graph costs one call. ONE step is captured and
replayed K times, not K steps as one graph, which would need K input slots
and K generators and hold K steps' activations.

``CapturedStep(fn, batch, what)`` captures ``fn(inputs, generator,
kl_weight)`` on static copies of ``batch`` (``inputs``), a
``torch.Generator`` registered with the graph and a float32 0-d KL weight.
``load(batch)`` copies a batch of the same signature (keys, shapes,
dtypes) into the inputs; ``run(seed, kl_weight)`` reseeds the generator (a
replay then draws what an eager step draws from a fresh generator of that
seed), fills the KL weight, replays, and returns ``outputs``, which the
next replay overwrites; ``replay`` is ``load`` then ``run``. Capture runs
``fn``'s Python once and executes nothing, so host state it moves is put
back: the kernels' launch counts here (each replay adds what the capture
launched, ``ops/cuda_build.py:add_launches``), the train state's step count
by the caller. The capture is ``thread_local``, so the prefetch thread may
use the card meanwhile. A capture that records nothing raises (PyTorch
only warns): its launches went to the stream of a card that is not the
current device, and a replay would hand back stale outputs. Nothing falls
back to eager steps on a failure.

``Replayer`` is the policy, one per multi step and per engine:

* a step on a batch off the card runs eagerly;
* a signature is warm once the owner ran a step of it eagerly on the card
  and said so (``note_eager``): that run builds what a capture cannot
  (cuBLAS and cuDNN handles, the ops' device constants, the kernels'
  first-launch host work). So the first step of each signature that a
  multi step or engine runs is eager;
* a replayer holds one graph: at the first warm batch while it has none,
  once the owner is ``ready()`` (for training, both Adams hold state, so
  that the capture does not record their lazy initialisation), the GRU
  kernels the configuration launches do their host work
  (``ops/gru.py:prepare_capture``), the step is captured, and the counter
  the owner named (``serve.graph_captures``, ``train.graph_captures``)
  adds one;
* a batch that does not fit the graph runs eagerly.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Mapping, Optional, Set, Tuple

import torch

from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.ops.cuda_build import add_launches, launch_counts
from vae_gan_mark_tpu_torch.utils.profiling import count

Batch = Mapping[str, torch.Tensor]
Signature = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def batch_signature(batch: Batch) -> Signature:
    """The keys, shapes and dtypes of a batch: what a graph is fixed to."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


class CapturedStep:
    """``fn(inputs, generator, kl_weight)`` captured as a CUDA graph on
    ``batch``'s device; ``what`` names it in an error."""

    def __init__(self, fn: Callable, batch: Batch, what: str = "the step"):
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
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn(self.inputs, self.generator,
                                      self.kl_weight)
        finally:
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in before})
        for w in caught:
            if "CUDA Graph is empty" in str(w.message):
                raise RuntimeError(
                    f"the capture of {what} on {device} recorded nothing: "
                    f"was it made on another card's stream? (PyTorch keeps "
                    f"one capture stream a process: use one card a "
                    f"process)")
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
        self.launches = {k: after[k] - before[k] for k in before
                         if after[k] != before[k]}

    def fits(self, batch: Batch) -> bool:
        return batch_signature(batch) == self.signature

    def load(self, batch: Batch) -> None:
        """Copy ``batch`` (which fits) into the inputs."""
        for key, static in self.inputs.items():
            static.copy_(batch[key])

    def run(self, seed: Optional[int] = None,
            kl_weight: Optional[float] = None):
        """Reseed and set the KL weight where given, replay; the outputs."""
        if seed is not None:
            self.generator.manual_seed(seed)
        if kl_weight is not None:
            self.kl_weight.fill_(kl_weight)
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs

    def replay(self, batch: Batch, seed: int, kl_weight: float):
        """``load(batch)``, then ``run(seed, kl_weight)``."""
        if not self.fits(batch):
            raise ValueError(f"a batch of signature {batch_signature(batch)}"
                             f" does not fit a graph of {self.signature}")
        self.load(batch)
        return self.run(seed, kl_weight)


class Replayer:
    """The module's policy for the steps of configuration ``cfg`` (with the
    GRU's backward when ``backward``), its capture counted in ``counter``."""

    def __init__(self, cfg, counter: str, what: str = "the step",
                 backward: bool = False):
        self.cfg = cfg
        self.counter = counter
        self.what = what
        self.backward = backward
        self.graph: Optional[CapturedStep] = None
        self._warm: Set[Signature] = set()

    def note_eager(self, batch: Batch) -> None:
        """A step ran eagerly on ``batch``."""
        if batch["ru"].device.type == "cuda":
            self._warm.add(batch_signature(batch))

    def load(self, batch: Batch) -> Optional[Dict[str, torch.Tensor]]:
        """The graph's inputs with ``batch`` copied in, where there is a
        graph and ``batch`` fits it; else None."""
        if self.graph is None or not self.graph.fits(batch):
            return None
        self.graph.load(batch)
        return self.graph.inputs

    def get(self, batch: Batch, capture: Callable,
            ready: Callable[[], bool] = lambda: True
            ) -> Tuple[Optional[CapturedStep], str]:
        """(the graph for a step on ``batch``, captured from ``capture``
        now if the policy says so, or None for an eager step; the step's
        kind: ``eager``, ``capture`` or ``replay``)."""
        if batch["ru"].device.type != "cuda":
            return None, "eager"
        if self.graph is None:
            if batch_signature(batch) not in self._warm or not ready():
                return None, "eager"
            gru.prepare_capture(self.cfg, batch["ru"].shape[0],
                                self.backward)
            self.graph = CapturedStep(capture, batch, self.what)
            count(self.counter)
            return self.graph, "capture"
        # A batch loaded into the inputs fits them.
        if batch is not self.graph.inputs and not self.graph.fits(batch):
            return None, "eager"
        return self.graph, "replay"
