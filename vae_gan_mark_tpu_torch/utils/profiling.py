"""Profiling: the program's spans and counters, and a ``torch.profiler``
exporter (the JAX package's ``utils/profiling.py``).

Spans mark what the host is doing at the serving and training layer
boundaries (``serve/``, ``train/``); nothing inside ``models/`` or ``ops/``
opens one. ``span(name, **attrs)`` is a context manager:

* while recording is off (the default) it returns one shared no-op object,
  after one test of a module flag: no clock read, no record;
* while it is on, each span keeps its name, its start and end in
  ``time.time_ns()`` nanoseconds (the wall clock that ``torch.profiler``'s
  device events carry, so a span lines up with the card's kernels), its
  id, its parent's id (from a stack per thread), its root's id (shared by
  every span of one request or one epoch), its thread's id and its
  attributes.

``count(name, n=1)`` adds to a counter under a lock (threads may share a
counter); counters are always on.
``recording()`` (or ``start()`` ... ``stop()``) turns spans on for a
block and hands back the spans it recorded and the counters' change over
it. Recordings nest: an inner one sees its own block.

``trace`` records a ``torch.profiler`` trace of its block (the host, and
the card's kernels when it is given a CUDA device), writes it as a Chrome
trace, and writes the block's spans and counters beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Union

import torch


class SpanRecord(NamedTuple):
    name: str
    start: int          # ns, time.time_ns()
    end: int
    id: int
    parent: int         # 0 for a root
    root: int
    thread: int         # threading.get_ident()
    attrs: dict


@dataclass
class Recording:
    """What a recording saw: its spans in the order they ended, and the
    counters that changed, by how much."""

    spans: List[SpanRecord] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)


_ON = False
_SPANS: List[SpanRecord] = []
_MARKS: list = []               # (first span, counters) of each recording
_COUNTERS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "start", "id", "parent", "root", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.stack = stack
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        if _ON:
            _SPANS.append(SpanRecord(self.name, self.start, end, self.id,
                                     self.parent, self.root,
                                     threading.get_ident(), self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the block (a step's kind)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager over one piece of the host's work."""
    if not _ON:
        return NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counters' totals since the process started."""
    with _COUNT_LOCK:
        return dict(_COUNTERS)


def start() -> None:
    """Turn spans on until the matching ``stop()``."""
    global _ON
    _MARKS.append((len(_SPANS), counters()))
    _ON = True


def stop() -> Recording:
    """The spans recorded since the matching ``start()`` and the
    counters' change; spans go off when the outermost recording stops."""
    global _ON
    if not _MARKS:
        raise RuntimeError("stop() without start()")
    first, before = _MARKS.pop()
    spans = _SPANS[first:]
    if not _MARKS:
        _ON = False
        _SPANS.clear()
    deltas = {k: v - before.get(k, 0) for k, v in counters().items()
              if v != before.get(k, 0)}
    return Recording(spans, deltas)


@contextlib.contextmanager
def recording():
    """Spans on for the block; yields a ``Recording`` that is filled when
    the block ends."""
    out = Recording()
    start()
    try:
        yield out
    finally:
        done = stop()
        out.spans, out.counters = done.spans, done.counters


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace",
          device: Optional[Union[str, torch.device]] = None):
    """Profile the block and write ``log_dir/name.trace.json``, with the
    block's spans and counters in ``log_dir/name.spans.json``; the card's
    kernels are recorded when ``device`` is a CUDA device. Yields the
    profiler (``key_averages()`` sums the recorded events)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec, profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.trace.json"))
    with open(os.path.join(log_dir, f"{name}.spans.json"), "w") as f:
        json.dump({"spans": [s._asdict() for s in rec.spans],
                   "counters": rec.counters}, f, default=str)
