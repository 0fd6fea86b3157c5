"""Named spans over the flush lifecycle (port of ``repro/obs/trace.py``):
wall-clock records always, profiler ranges when a profile is active.

The engine's hot path is wrapped in nested spans (``flush -> drain``, and
``ticket-wait`` around :meth:`~repro_torch.core.stream.FlushTicket.wait`).
Every span opens a ``torch.profiler.record_function`` range, so it shows
as a host range in a ``torch.profiler`` trace with the kernels launched
inside it attributed to it, AND appends a host-side :class:`Span` record
with wall-clock start / end and its nesting depth, so span data exists
without a profiler attached.  The times are the host's: a drain's span
closes when K1 was launched, not when it finished on the card.

Records live in a bounded ring (:func:`spans` reads, :func:`reset_spans`
clears).  :class:`FlushTiming` is the per-flush timing the engine stashes
and ``FlushTicket.timing`` carries: queue residency (first enqueue ->
flush call), drain wall-clock, bucket-padded table length and launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from torch.profiler import record_function

from repro_torch.obs.metrics import now

#: bounded span-record ring size (oldest records drop past this)
MAX_SPANS = 4096

_RECORDS: List["Span"] = []
_STACK: List[int] = []
_ENABLED = True


@dataclasses.dataclass
class Span:
    """One recorded span: name, wall-clock bounds, nesting, labels."""

    name: str                      #: span name (e.g. "flush", "drain")
    start: float                   #: perf_counter seconds at entry
    end: float                     #: perf_counter seconds at exit
    depth: int                     #: nesting depth (0 = root)
    parent: int                    #: index of the enclosing span, -1 = root
    labels: Tuple[Tuple[str, str], ...] = ()   #: sorted label pairs

    @property
    def us(self) -> float:
        """Span duration in microseconds."""
        return (self.end - self.start) * 1e6


@dataclasses.dataclass(frozen=True)
class FlushTiming:
    """Per-flush timing carried by ``FlushTicket.timing``: how long rows
    sat queued, how long the drain took on the host (K1 launches
    asynchronously: this is not its device time), how big the padded
    table was, and how many launches it cost."""

    queue_residency_us: float      #: first enqueue -> flush call
    drain_us: float                #: _drain_rows wall-clock (host)
    table_len: int                 #: bucket-padded rows dispatched (all chunks)
    launches: int                  #: device launches the flush issued


@contextlib.contextmanager
def span(name: str, **labels) -> Iterator[None]:
    """Open a named span: a ``torch.profiler.record_function`` range, and
    a wall-clock :class:`Span` record (bounded ring; see :func:`spans`).
    Spans nest: the record keeps its depth and parent index.  A span that
    an exception leaves is closed and popped all the same."""
    if not _ENABLED:
        yield
        return
    parent = _STACK[-1] if _STACK else -1
    depth = len(_STACK)
    idx = len(_RECORDS)
    rec = Span(name=name, start=now(), end=0.0, depth=depth, parent=parent,
               labels=tuple(sorted((k, str(v)) for k, v in labels.items())))
    _RECORDS.append(rec)
    _STACK.append(idx)
    try:
        with record_function(name):
            yield
    finally:
        rec.end = now()
        _STACK.pop()
        if len(_RECORDS) > MAX_SPANS:
            drop = len(_RECORDS) - MAX_SPANS
            del _RECORDS[:drop]
            # re-anchor parent indices after the ring dropped a prefix; a
            # span still open whose record dropped stays on the stack as
            # -1 (a root), so that its own exit still pops it (the
            # reference drops it from the stack, and that exit raises)
            for r in _RECORDS:
                r.parent = r.parent - drop if r.parent >= drop else -1
            _STACK[:] = [i - drop if i >= drop else -1 for i in _STACK]


def spans(name: Optional[str] = None) -> List[Span]:
    """Recorded spans (optionally filtered by name), oldest first."""
    if name is None:
        return list(_RECORDS)
    return [r for r in _RECORDS if r.name == name]


def reset_spans() -> None:
    """Clear the span record ring (test isolation)."""
    _RECORDS.clear()
    _STACK.clear()


def tracing_enabled() -> bool:
    """Is span recording currently on?"""
    return _ENABLED


def set_tracing(flag: bool) -> bool:
    """Enable or disable span recording; returns the PREVIOUS state.  Off
    skips both the record and the profiler range; the engine's behaviour
    is unchanged either way (host-side only)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def span_tree(records: Optional[List[Span]] = None) -> List[Dict]:
    """Span records as a nested dict tree (children inline): one round's
    ``flush -> drain`` hierarchy."""
    records = _RECORDS if records is None else records
    nodes = [{"name": r.name, "us": r.us, "labels": dict(r.labels),
              "children": []} for r in records]
    roots: List[Dict] = []
    for i, r in enumerate(records):
        if 0 <= r.parent < len(nodes):
            nodes[r.parent]["children"].append(nodes[i])
        else:
            roots.append(nodes[i])
    return roots


__all__ = ["Span", "FlushTiming", "span", "spans", "reset_spans", "tracing_enabled", "set_tracing", "span_tree",
           "MAX_SPANS"]
