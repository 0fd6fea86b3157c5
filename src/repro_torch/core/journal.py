"""Ticket journal — the engine's log of drained flushes.

The port's copy of ``repro/core/journal.py``, append and read side only:
every successful flush appends one :class:`JournalRecord` holding the
exact (WAR-spaced) rows the drain consumed, its engine-wide index and its
launch accounting, to a bounded :class:`TicketJournal` ring.  Replay and
recovery are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One drained flush, as the dispatch loop consumed it (spacer
    ``OP_NOP`` rows included)."""

    stream: str                       #: name of the draining stream/queue
    index: int                        #: engine-wide flush index
    rows: Tuple[Tuple[int, int, int], ...]  #: spaced rows, as dispatched
    plan_sig: Optional[Tuple] = None  #: always None: single device only
    launches: int = 0                 #: device launches the drain issued
    war_hazards: int = 0              #: queue's cumulative WAR admissions
    spacer_rows: int = 0              #: queue's cumulative spacer rows
    aborted: bool = False             #: True = prefix of a failed flush


class TicketJournal:
    """Bounded in-engine log of drained flushes (oldest fall off past
    ``capacity``)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._records: collections.deque = collections.deque(
            maxlen=capacity)

    def __len__(self) -> int:
        return len(self._records)

    def append(self, record: JournalRecord) -> None:
        """Append one flush record."""
        self._records.append(record)

    @property
    def records(self) -> Tuple[JournalRecord, ...]:
        """The retained records, oldest first."""
        return tuple(self._records)


__all__ = ["JournalRecord", "TicketJournal"]
