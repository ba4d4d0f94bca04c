"""Device activity from ``torch.profiler``, the program's own spans and
counters, and their reduction.

A ``DeviceTrace`` records the card's activity alone (kernels, copies,
memsets: ``ProfilerActivity.CUDA``), so the profiler adds little host work.
Its events carry wall-clock nanoseconds, the clock of ``time.time_ns()``,
so they line up with the harness's own spans. A ``ProgramTrace`` turns on
the program's span recorder (``vae_gan_mark_tpu_torch/utils/profiling.py``)
for the same slice; its spans carry the same clock. ``busy_ns`` is the
length of the union of the events inside an interval (overlapping kernels
count once); the kernel classes are the repository's profile classes, first
match wins.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Sequence, Tuple

KERNEL_CLASSES = (  # first match wins; matched against the kernel's name
    ("gru forward kernel", ("gru_fwd_kernel",)),
    ("gru backward kernel", ("gru_bwd_kernel",)),
    ("conv dgrad", ("dgrad",)),
    ("conv wgrad", ("wgrad",)),
    ("upsample", ("upsample",)),
    ("convolution", ("conv", "implicit_gemm", "xmma", "fft", "winograd",
                     "pointwise_mult_and_sum_complex",
                     "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul", ("gemm", "gemv", "splitK")),
    ("optimizer", ("adam", "Adam", "multi_tensor")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
)
ELEMENTWISE = "other elementwise / reduction"


class Event(NamedTuple):
    name: str
    start: int      # ns, wall clock
    end: int


class Span(NamedTuple):
    label: str
    start: int
    end: int


def kernel_class(name: str) -> str:
    for cls, needles in KERNEL_CLASSES:
        if any(n in name for n in needles):
            return cls
    return ELEMENTWISE


def now_ns() -> int:
    return time.time_ns()


class DeviceTrace:
    """``start()`` ... ``stop()`` -> the device events in between."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> List[Event]:
        self.prof.stop()
        from torch.autograd import DeviceType
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns()
            out.append(Event(e.name(), start, start + e.duration_ns()))
        out.sort(key=lambda e: e.start)
        return out


class ProgramTrace:
    """``start()`` ... ``stop()`` -> the program's ``Recording``: its spans
    (``SpanRecord``) and the change of its counters in between. The
    recorder is on only between the two calls; a run that never starts
    one records no span."""

    def __init__(self):
        from vae_gan_mark_tpu_torch.utils import profiling
        self.profiling = profiling

    def start(self) -> None:
        self.profiling.start()

    def stop(self):
        return self.profiling.stop()


def clip(events: Sequence[Event], t0: int, t1: int) -> List[Event]:
    return [Event(e.name, max(e.start, t0), min(e.end, t1)) for e in events
            if e.end > t0 and e.start < t1]


def clip_spans(spans: Sequence, t0: int, t1: int) -> list:
    """The program's spans that overlap [t0, t1], cut to it."""
    return [s._replace(start=max(s.start, t0), end=min(s.end, t1))
            for s in spans if s.end > t0 and s.start < t1]


def intervals(events: Sequence[Event]) -> List[Tuple[int, int]]:
    """The union of the events as sorted, disjoint intervals."""
    merged: List[List[int]] = []
    for e in sorted(events, key=lambda e: e.start):
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    return [(a, b) for a, b in merged]


def busy_ns(events: Sequence[Event], t0: int, t1: int) -> int:
    return sum(b - a for a, b in intervals(clip(events, t0, t1)))


def by_name(events: Sequence[Event]) -> List[Tuple[str, float]]:
    totals = {}
    for e in events:
        totals[e.name] = totals.get(e.name, 0) + (e.end - e.start)
    return sorted(((k, v / 1e9) for k, v in totals.items()),
                  key=lambda kv: -kv[1])


def by_class(events: Sequence[Event]) -> List[Tuple[str, float]]:
    totals = {}
    for e in events:
        cls = kernel_class(e.name)
        totals[cls] = totals.get(cls, 0) + (e.end - e.start)
    return sorted(((k, v / 1e9) for k, v in totals.items()),
                  key=lambda kv: -kv[1])


def innermost(spans: Sequence, t: int):
    """The innermost of the main thread's program spans around ``t``, or
    None: of nested spans, the one that started last."""
    main = threading.main_thread().ident
    around = [s for s in spans if s.thread == main and s.start <= t < s.end]
    return max(around, key=lambda s: (s.start, -s.end), default=None)


def idle_gaps(events: Sequence[Event], spans: Sequence[Span], t0: int,
              t1: int, top: int = 10,
              program_spans: Sequence = ()) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device activity inside [t0, t1],
    longest first, each named by the harness span around its middle and,
    where the program recorded one there, the innermost main-thread program
    span (``request/serve.copy_in``)."""
    busy = intervals(clip(events, t0, t1))
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:top]
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        label = next((s.label for s in spans if s.start <= mid < s.end),
                     "harness")
        inner = innermost(program_spans, mid)
        if inner is not None:
            label = f"{label}/{inner.name}"
        out.append((label, length / 1e9))
    return out


def breakdown(events: Sequence[Event], spans: Sequence[Span], t0: int,
              t1: int, program_spans: Sequence = ()) -> dict:
    inside = clip(events, t0, t1)
    ops = by_name(inside)[:10]
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[label, s] for label, s in
                          idle_gaps(inside, spans, t0, t1,
                                    program_spans=program_spans)]}
