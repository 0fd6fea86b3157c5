"""Command streams — ``CommandStream`` and ``FlushTicket`` (port of
``repro/core/stream.py``).

A :class:`CommandStream` is an ordered stream of bulk-movement commands on
one engine: its verbs enqueue without flushing, :meth:`CommandStream.capture`
routes every engine call in a region onto it, and :meth:`CommandStream.flush`
drains it and returns a :class:`FlushTicket`.  Streams are unordered
against each other until they touch the same ``(pool, block)``; then the
earlier stream drains first (the engine's cross-stream guard).

The pools are updated in place, so a ticket cannot keep the post-drain
bytes alive as the JAX version's donated buffers did.  Instead every pool
carries a generation counter that each in-place write bumps (a later drain,
or the serving decode step's K/V append); a ticket whose pools moved on is
:attr:`~FlushTicket.expired` and its :meth:`~FlushTicket.block_state`
raises, as the reference does once its buffers were donated.  Killing a
pool (``RowCloneEngine.kill_pool``) bumps its generation too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cmdqueue import CommandQueue
from repro_torch.core.poolspec import BlockRef
from repro_torch.obs.trace import FlushTiming, span


@dataclasses.dataclass(frozen=True)
class FlushTicket:
    """Receipt for one :meth:`CommandStream.flush`: launch accounting plus
    the pool generations right after the drain.  Metadata never expires;
    block state is readable while those generations still hold."""

    stream: str                 #: name of the stream that flushed
    seq: int                    #: flush sequence number on that stream
    commands: int               #: command rows drained by this flush
    launches: int               #: device launches the drain issued
    war_hazards: int            #: cumulative WAR commands admitted so far
    spacer_rows: int            #: cumulative spacer rows inserted
    index: int                  #: engine-wide flush index (-1: empty flush)
    touched: Tuple[str, ...]    #: pools this flush WROTE
    _engine: Any = dataclasses.field(repr=False)
    _gens: Dict[str, int] = dataclasses.field(repr=False)
    #: one CUDA event per card that holds the engine's pools (every rank's
    #: card under a mesh), recorded on its current stream after the drain
    _events: Tuple[Any, ...] = dataclasses.field(default=(), repr=False)
    #: the drain's timing (queue residency, drain wall-clock, padded
    #: table length, launches); None on an empty flush
    timing: Optional[FlushTiming] = None

    @property
    def moved(self) -> bool:
        """Did this flush issue any device work?"""
        return self.launches > 0

    def _stale(self, names: Sequence[str]) -> bool:
        gens = self._engine.pool_generation
        return any(gens[n] != self._gens[n] for n in names)

    @property
    def expired(self) -> bool:
        """True once a later in-place write moved any of the ticket's
        pools past the state this flush left."""
        return self._stale(list(self._gens))

    def _check_live(self, names: Sequence[str]) -> None:
        if self._stale(names):
            raise RuntimeError(
                f"FlushTicket(stream={self.stream!r}, seq={self.seq}) "
                "expired: a later in-place write changed the pools it "
                "describes — read block_state() before the next flush "
                "(ticket metadata never expires)")

    def wait(self) -> "FlushTicket":
        """Block until the drain finished on the device.  Scoped to the
        pools the flush WROTE (``touched``): a later write to, or the
        death of, any other pool leaves it valid (a checkpoint ticket
        survives the decode step and a killed primary); a touched pool
        that was killed raises, as the reference's deleted buffer does."""
        eng = self._engine
        if any(eng.pool_is_dead(n) for n in self.touched):
            raise RuntimeError(
                f"FlushTicket(stream={self.stream!r}, seq={self.seq}) "
                "expired: a pool it wrote was killed")
        with span("ticket-wait", stream=self.stream, seq=self.seq):
            for event in self._events:
                event.synchronize()
        return self

    def block_state(self, ref: Union[BlockRef, int]
                    ) -> Union[np.ndarray, Dict[str, np.ndarray]]:
        """Post-drain contents of one block, copied to the host.  A
        :class:`BlockRef` returns that pool's block; a bare int (a primary
        id) returns ``{pool name: block}`` over every primary pool."""
        eng = self._engine
        ba = eng.block_axis

        def fetch(name: str, b: int) -> np.ndarray:
            return eng.block(name, b).to("cpu", copy=True).numpy()

        if isinstance(ref, BlockRef):
            self._check_live([ref.pool])
            return fetch(ref.pool, int(ref.block))
        self._check_live(eng.primary_names)
        return {name: fetch(name, int(ref)) for name in eng.primary_names}


class CommandStream:
    """An ordered bulk-movement command stream on one RowCloneEngine
    (mint with ``engine.stream(name)``).  Enqueue calls mirror the engine's
    verbs but do NOT flush on return."""

    def __init__(self, engine, name: str):
        self.engine = weakref.proxy(engine)    # the engine owns its streams
        self.name = name
        self.queue = CommandQueue(engine)
        self.queue.name = name
        self._seq = 0

    def __len__(self) -> int:
        return len(self.queue)

    @property
    def pending(self):
        """Copy of the not-yet-flushed ``(opcode, src, dst)`` rows."""
        return self.queue.pending

    @contextlib.contextmanager
    def capture(self) -> Iterator["CommandStream"]:
        """Route every engine enqueue inside the block onto THIS stream,
        deferred (no flush-on-return)."""
        eng = self.engine
        prev_q, prev_d = eng._cur_queue, eng.deferred
        eng._cur_queue, eng.deferred = self.queue, True
        try:
            yield self
        finally:
            eng._cur_queue, eng.deferred = prev_q, prev_d

    # the engine's verbs, routed onto this stream --------------------------
    def memcopy(self, pairs, dst_is_fresh: bool = False):
        with self.capture():
            return self.engine.memcopy(pairs, dst_is_fresh=dst_is_fresh)

    def memcopy_cross(self, pairs):
        with self.capture():
            return self.engine.memcopy_cross(pairs)

    def meminit(self, ids, lazy: Optional[bool] = None):
        with self.capture():
            return self.engine.meminit(ids, lazy=lazy)

    def memand(self, triples):
        with self.capture():
            return self.engine.memand(triples)

    def memor(self, triples):
        with self.capture():
            return self.engine.memor(triples)

    def memnot(self, pairs):
        with self.capture():
            return self.engine.memnot(pairs)

    def materialize_zeros(self, ids):
        with self.capture():
            return self.engine.materialize_zeros(ids)

    def promote_staged(self, pairs):
        with self.capture():
            return self.engine.promote_staged(pairs)

    def demote_to_spill(self, blocks):
        """Enqueue primary -> spill demotions; returns the slot ids."""
        with self.capture():
            return self.engine.demote_to_spill(blocks)

    def promote_spilled(self, pairs):
        """Enqueue spill -> primary resume promotions."""
        with self.capture():
            return self.engine.promote_spilled(pairs)

    # ------------------------------------------------------------------
    def adopt(self, other: "CommandStream") -> int:
        """Move another stream's pending rows onto THIS stream (the
        scheduler's lane merge: adoption order is enqueue order, so one
        flush drains every lane's work as one launch with the
        higher-priority lanes' rows first).  ``other``'s queue empties
        without dispatching, and leaves the engine's live set, before the
        first row re-enqueues here, so the cross-stream guard never
        flushes it; each row then runs the full hazard matrix again.
        Returns the number of rows adopted."""
        if other is self:
            return 0
        rows = other.queue.abort()
        for op, s, d in rows:
            self.queue.enqueue(op, s, d)
        return len(rows)

    # ------------------------------------------------------------------
    def flush(self) -> FlushTicket:
        """Drain the stream's pending commands and return the receipt."""
        eng = self.engine
        rows = self.queue.pending
        n = len(rows)
        index = eng.next_flush_index if n else -1
        with span("flush", stream=self.name, seq=self._seq):
            launches = self.queue.flush()
        timing = eng.last_drain_timing if n else None
        events = []
        if launches:
            import torch
            for dev in eng.devices:
                if dev.type == "cuda":
                    events.append(torch.cuda.Event())
                    events[-1].record(torch.cuda.current_stream(dev))
        ticket = FlushTicket(
            stream=self.name, seq=self._seq, commands=n, launches=launches,
            war_hazards=self.queue.stats.war_hazards,
            spacer_rows=self.queue.stats.spacer_rows, index=index,
            touched=eng._touched_pools(rows), _engine=eng,
            _gens=dict(eng.pool_generation), _events=tuple(events), timing=timing)
        self._seq += 1
        return ticket


__all__ = ["CommandStream", "FlushTicket"]
