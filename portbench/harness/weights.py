"""Weights from the seed, made on the device in two large draws.

The leaves and their initialisers come from the reference modules built on
the meta device (each leaf carries ``init``: torch's default for its layer
kind): the generator of the cell's reference module, then the shared
discriminator and VGG head. One ``torch.rand`` covers every uniform leaf
and one ``torch.randn`` every normal leaf; each leaf is then a scaled view
of its slice, and the reference module's ``fix_weights`` sets what the
draws must not decide. The same state dicts go to the program and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference.model import Discriminator, VGGHead

StateDict = Dict[str, torch.Tensor]


def _leaves(module: torch.nn.Module):
    for name, t in list(module.named_parameters()) + \
            list(module.named_buffers()):
        init = getattr(t, "init", None)
        if init is not None:
            yield name, tuple(t.shape), init


def make_state_dicts(cell, seed: int, device
                     ) -> Tuple[StateDict, StateDict, StateDict]:
    """(G, D, VGG) state dicts of ``cell``'s configuration, float32 on
    ``device``."""
    arch = cell.reference
    with torch.device("meta"):
        modules = {"G": arch.Generator(cell.config), "D": Discriminator(),
                   "VGG": VGGHead()}
    leaves = [(part, name, shape, init) for part, m in modules.items()
              for name, shape, init in _leaves(m)]
    uniform = sum(math.prod(s) for _, _, s, (k, _, _) in leaves
                  if k in ("fan_in", "gru"))
    normal = sum(math.prod(s) for _, _, s, (k, _, _) in leaves
                 if k in ("normal", "fan_out_normal", "unit_normal"))
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(uniform, generator=gen, device=device) * 2.0 - 1.0
    n = torch.randn(normal, generator=gen, device=device)
    out: Dict[str, StateDict] = {p: {} for p in modules}
    iu = inn = 0
    for part, name, shape, (kind, fan, value) in leaves:
        size = math.prod(shape)
        if kind in ("fan_in", "gru"):
            t = u[iu:iu + size].view(shape) / math.sqrt(fan)
            iu += size
        elif kind in ("normal", "fan_out_normal", "unit_normal"):
            t = n[inn:inn + size].view(shape)
            inn += size
            if kind == "fan_out_normal":
                t = t * math.sqrt(2.0 / fan)
            elif kind == "unit_normal":
                t = t / torch.linalg.vector_norm(t)
            elif value:
                t = t * value
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "const":
            t = torch.full(shape, value, device=device)
        else:
            raise ValueError(f"init {kind!r} of {part}.{name}")
        out[part][name] = t.clone()
    arch.fix_weights(out["G"])
    return out["G"], out["D"], out["VGG"]
