"""What readers of the program's spans share (``TracedRun.program_spans``:
the ``SpanRecord``s of ``vae_gan_mark_tpu_torch/utils/profiling.py``, cut
to the traced slice, each with its name, start and end in wall-clock ns,
id, parent's id, root's id and thread)."""

from __future__ import annotations

from typing import Dict, List

from harness.trace import Event, busy_ns, intervals


def named(run, name: str) -> list:
    """The slice's spans called ``name``, in the order they ended."""
    return [s for s in run.program_spans if s.name == name]


def by_root(run, root: str = None) -> List[list]:
    """The slice's spans grouped by their root (one request, one epoch),
    in the order the roots started; with ``root``, the groups whose root
    span is called so. A group whose root lies outside the slice is left
    out."""
    groups: Dict[int, list] = {}
    for s in run.program_spans:
        groups.setdefault(s.root, []).append(s)
    heads = {s.id: s for s in run.program_spans if s.id == s.root}
    return [groups[i] for i in sorted(heads, key=lambda i: heads[i].start)
            if root is None or heads[i].name == root]


def total_ns(spans, *names: str) -> int:
    """The summed length of the spans called one of ``names``."""
    return sum(s.end - s.start for s in spans if s.name in names)


def self_ns(span, spans) -> int:
    """``span``'s length less what its child spans cover."""
    children = [Event(s.name, s.start, s.end) for s in spans
                if s.parent == span.id]
    return (span.end - span.start) - busy_ns(children, span.start, span.end)


def idle_in(run, name: str) -> int:
    """The device's idle ns inside the spans called ``name`` (their union,
    so nested or overlapping spans count once), from ``run.events``."""
    covered = intervals([Event(name, s.start, s.end)
                         for s in named(run, name)])
    return sum((b - a) - busy_ns(run.events, a, b) for a, b in covered)
