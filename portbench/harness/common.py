"""What both kinds of cell share: the traced slice handed to the per-layer
readers, the device record, the check that JAX stayed out, and the result
line."""

from __future__ import annotations

import contextlib
import gc
import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from harness import manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_gan_mark_tpu")


@dataclass
class TracedRun:
    """What a per-layer reader reads: the traced slice [t0, t1] (wall-clock
    ns) with the device events inside it, the harness's spans over the
    whole window, the program's own spans and counters over the slice, the
    work done inside the slice, and the least time of a unit of work at the
    card's peaks.

    ``program_spans`` are the ``SpanRecord``s (name, start, end, id, parent,
    root, thread, attrs) that ``vae_gan_mark_tpu_torch/utils/profiling.py``
    recorded while the slice ran, cut to [t0, t1]; ``counters`` is the
    change of each of its counters over the slice (a counter that did not
    change is absent). Both are empty where nothing was recorded. The
    recorder runs in ``--trace 1`` runs alone, so the timed runs pay nothing
    for it. ``harness/spans.py`` has what readers of them share: spans by
    name, spans grouped by root, a span's self time, and the device's idle
    time inside the spans of one name.

    A configuration whose program records spans or counters of its own adds
    their readers as new files, ``metrics/<name>.py`` with ``read(run)``,
    and their ``per_layer`` entries in ``BENCHMARK.json``; no harness file
    changes. A reader that finds nothing to read returns None and its
    metric is left out of the line."""

    cfg: dict
    traffic: dict
    t0: int
    t1: int
    events: List[trace.Event]
    spans: List[trace.Span]
    window_s: float
    steps: int = 0                         # train steps in the slice
    requests: List = field(default_factory=list)   # (t0, t1, patches)
    least_unit_s: float = 0.0              # a train step or a patch
    program_spans: List = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def slice_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return trace.busy_ns(self.events, self.t0, self.t1) / 1e9

    @property
    def graph_captures(self) -> int:
        """CUDA-graph captures inside the slice (the ``*.graph_captures``
        counters): a capture there would spoil what the readers read."""
        return sum(v for k, v in self.counters.items()
                   if k.endswith(".graph_captures"))


def read_per_layer(cell: manifest.Cell, run: TracedRun) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_record(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def float32_scope():
    """TF32 off for the reference's float32 products."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def settle() -> None:
    """Before a window: collect what set-up left and freeze the survivors,
    so the collector does not walk set-up's objects inside the window."""
    gc.collect()
    gc.freeze()


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Dict[str, dict],
                breakdown: Optional[dict] = None,
                extra: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: Dict[str, dict]) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
