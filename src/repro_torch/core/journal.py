"""Ticket journal — the engine's replayable flush log (port of
``repro/core/journal.py``).

Every successful flush appends one :class:`JournalRecord` — the exact
(WAR-spaced) rows the drain consumed, its engine-wide index and its launch
accounting — to a bounded :class:`TicketJournal` ring.  A drained table
maps pool state to pool state with no host randomness, so recovery
composes two primitives:

* :class:`PoolSnapshot` — host copies of the pools, stamped with the last
  flush index they include (``RowCloneEngine.snapshot()``, or a pass of
  the checkpoint stream, checkpoint/pool_checkpoint.py);
* :meth:`TicketJournal.replay` — re-drains every record after a
  snapshot's index onto the restored pools.  Records hold the spaced rows
  verbatim and replay feeds them through pre-spaced, so the replayed
  drains build the same tables and leave bitwise-identical pools.

What the journal does NOT cover: writes that bypass the command queue —
the serving decode step's K/V append and the prefill's staging write.
Those bytes are reproduced by re-running their producers (recovery evicts
and re-admits the affected sequences), never by replay; a snapshot taken
at a quiesced flush boundary is exact.

Failures the recovery path handles are raised on the host: a drain guard
(an injected fault), or a wrapper that refuses a pool whose storage was
freed (``RowCloneEngine.kill_pool``, the port's counterpart of a donated
buffer).  Both raise before the kernel launches, so the pools hold the
state of the chunks that did dispatch.  An asynchronous CUDA error raised
by a kernel that already launched is sticky for the process and cannot be
recovered in process; it is not part of this contract.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.opcodes import OP_NOP, row_rw

#: numpy has no bfloat16: host copies carry its bits as uint16
_HOST_BITS = {torch.bfloat16: np.uint16}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a host copy of a ``dtype`` tensor."""
    if dtype in _HOST_BITS:
        return np.dtype(_HOST_BITS[dtype])
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``'s bits (bfloat16 as uint16), one device ->
    host copy."""
    bf = t.dtype in _HOST_BITS
    t = t.detach().view(torch.int16) if bf else t.detach()
    h = t.to("cpu", copy=True).numpy()
    return h.view(np.uint16) if bf else h


def from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a host copy.  A bfloat16
    target takes an array of 2-byte items (uint16 bits, or a bfloat16
    array the JAX package wrote) bit for bit; other arrays convert by
    value."""
    shape = np.shape(a)           # ascontiguousarray makes a 0-d array 1-d
    a = np.ascontiguousarray(np.asarray(a)).reshape(shape)
    size = torch.empty((), dtype=dtype).element_size()
    if a.dtype.itemsize == size and (dtype in _HOST_BITS
                                     or a.dtype.kind not in "fiub"):
        src = torch.from_numpy(a.reshape(-1).view(np.uint8).copy()).view(
            dtype).reshape(a.shape)
    else:
        src = torch.from_numpy(a.copy())
    # a tensor that owns its storage (a pool restored from it can be
    # killed again), filled with one host -> device copy
    return torch.empty(a.shape, dtype=dtype, device=device).copy_(src)


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One drained flush, as the dispatch loop consumed it (spacer
    ``OP_NOP`` rows included; replay feeds them back pre-spaced).  An
    ``aborted`` record holds only the chunks that dispatched before a
    mid-flush failure; the suffix is stashed on the engine."""

    stream: str                       #: name of the draining stream/queue
    index: int                        #: engine-wide flush index
    rows: Tuple[Tuple[int, int, int], ...]  #: spaced rows, as dispatched
    plan_sig: Optional[Tuple] = None  #: always None: single device only
    launches: int = 0                 #: device launches the drain issued
    war_hazards: int = 0              #: queue's cumulative WAR admissions
    spacer_rows: int = 0              #: queue's cumulative spacer rows
    aborted: bool = False             #: True = prefix of a failed flush


@dataclasses.dataclass(frozen=True)
class PoolSnapshot:
    """Host copies of pools, consistent through flush ``index``.

    ``arrays`` maps pool name -> numpy array of the pool's raw bits in
    the pool's shape: float32 pools as float32, bfloat16 pools as uint16
    bit patterns (numpy has no bfloat16; the JAX -> torch handoff carries
    bf16 the same way).  Restore reinterprets the bits, so it is bitwise.
    A snapshot need not cover every pool (the checkpoint stream snapshots
    the primaries only).  Replay applies the records with ``record.index >
    index``."""

    index: int
    arrays: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AbortedFlush:
    """The undispatched remainder of a flush that failed mid-drain
    (``RowCloneEngine.recover`` re-drains ``suffix``, already spaced,
    with retry and backoff)."""

    queue: str                        #: name of the flushing queue
    index: int                        #: the failed flush's index
    rows: Tuple[Tuple[int, int, int], ...]    #: full raw rows, pre-spacing
    suffix: Tuple[Tuple[int, int, int], ...]  #: spaced rows not dispatched


class RecoveryError(RuntimeError):
    """Recovery exhausted its retries (or a journal record fails the
    opcode contract): the engine could not be returned to a serviceable
    state."""


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What one ``RowCloneEngine.recover()`` pass did."""

    evicted_rows: int         #: queued commands dropped from live streams
    evicted_promotions: int   #: of those, staging→primary promotions
    pools_restored: Tuple[str, ...]  #: pools restored from the snapshot
    pools_lost: Tuple[str, ...]      #: dead pools resurrected as zeros
    replayed_flushes: int     #: journal records re-drained
    redrained_flushes: int    #: aborted-flush suffixes re-drained
    retries: int              #: failed re-drain attempts before success
    degraded: bool            #: True = staging ring in degraded capacity


class TicketJournal:
    """Bounded in-engine log of drained flushes (oldest fall off past
    ``capacity``).  A :class:`PoolSnapshot` is replayable only while every
    record after its index is still in the ring."""

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

    @property
    def head_index(self) -> int:
        """Flush index of the oldest retained record (-1 when empty)."""
        return self._records[0].index if self._records else -1

    @property
    def last_index(self) -> int:
        """Flush index of the newest retained record (-1 when empty)."""
        return self._records[-1].index if self._records else -1

    def since(self, index: int) -> List[JournalRecord]:
        """Records with ``record.index > index``, oldest first."""
        return [r for r in self._records if r.index > index]

    def replay(self, engine, after: int = -1) -> int:
        """Re-drain every record after flush ``after`` onto the engine's
        (restored) pools, in order, pre-spaced.  Returns the number of
        flushes replayed.

        Every row of every record is checked against the opcode registry
        (``row_rw``: a registered opcode, operands inside the engine's
        address space and the two-source packing bound) BEFORE anything
        re-drains; a bad row raises :class:`RecoveryError`."""
        todo = self.since(after)
        group = engine.group
        for rec in todo:
            for i, (op, s, d) in enumerate(rec.rows):
                try:
                    if op < 0:
                        if (op, s, d) != (OP_NOP, -1, -1):
                            raise ValueError(
                                f"padding row must be (OP_NOP, -1, -1), "
                                f"got ({op}, {s}, {d})")
                        continue
                    row_rw(op, s, d, group.locate, group.total_blocks)
                except ValueError as e:
                    raise RecoveryError(
                        f"journal record {rec.index} (stream "
                        f"{rec.stream!r}) row {i} fails the opcode "
                        f"contract: {e}") from e
        for rec in todo:
            engine._drain_rows(list(rec.rows), record=False,
                               pre_spaced=True)
        return len(todo)


__all__ = ["JournalRecord", "PoolSnapshot", "AbortedFlush", "RecoveryError",
           "RecoveryReport", "TicketJournal", "host_dtype", "to_host",
           "from_host"]
