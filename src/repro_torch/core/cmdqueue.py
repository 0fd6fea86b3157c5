"""CommandQueue — the memory-controller command buffer for bulk movement.

The port's copy of ``repro/core/cmdqueue.py`` (single device).  Callers
enqueue tagged ``(opcode, src, dst)`` rows; the device sees work only at
flush boundaries, where the whole table drains as ONE fused launch over
every pool (kernels/fused_dispatch.py).  Tables pad to the
power-of-two buckets 8/32/128/512; longer tables drain in overflow chunks.
The buckets are kept although a CUDA drain does not recompile per shape:
they keep the journal rows comparable with the reference.  The set is
process-wide and a tuned profile may retarget it (:func:`set_buckets`);
read it through :func:`get_buckets`.

Hazard guards track both sides of every pending command as ``(pool,
block)`` keys (plain opcodes touch the block in every primary pool):

* **RAW** — reading a pending destination: auto-flush first.
* **WAW** — rewriting a pending destination: auto-flush first.
* **WAR** — overwriting a pending SOURCE: admitted and counted in
  ``stats.war_hazards``.  :func:`space_war_rows` still inserts an
  ``OP_NOP`` spacer between adjacent WAR pairs at flush time, so the
  journal matches the reference row for row; the CUDA drain orders every
  WAR writer after all earlier readers by its wave schedule
  (kernels/fused_dispatch.py ``wave_schedule``), adjacent or not.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.opcodes import (ALL_PRIMARY, OP_NOP, OP_ZERO_INIT,
                                      OPCODE_NAMES, keys_clash, row_rw)
from repro_torch.obs import metrics as obs_metrics

#: the hand-picked bucket set (what :func:`set_buckets` restores on None)
DEFAULT_BUCKETS: Tuple[int, ...] = (8, 32, 128, 512)

#: padding buckets — the only command-table lengths a flush produces.
#: Module-global so a tuned profile can retarget it process-wide; read it
#: through :func:`get_buckets`, not a from-import (which would freeze it).
BUCKETS: Tuple[int, ...] = DEFAULT_BUCKETS


def set_buckets(buckets: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Retarget the process-wide bucket set (``None`` restores
    :data:`DEFAULT_BUCKETS`): strictly increasing positive ints.  Every
    later flush pads to the new set (padding rows are ``OP_NOP``, so pool
    bytes are unaffected).  Returns the installed tuple."""
    global BUCKETS
    if buckets is None:
        BUCKETS = DEFAULT_BUCKETS
        return BUCKETS
    bs = tuple(int(b) for b in buckets)
    if not bs or any(b <= 0 for b in bs) or list(bs) != sorted(set(bs)):
        raise ValueError(f"buckets must be strictly increasing positive "
                         f"ints, got {buckets!r}")
    BUCKETS = bs
    return BUCKETS


def get_buckets() -> Tuple[int, ...]:
    """The current process-wide bucket set (see :func:`set_buckets`)."""
    return BUCKETS


def top_bucket() -> int:
    """The largest bucket — the overflow chunk size of every drain."""
    return get_buckets()[-1]


def bucket_size(n: int) -> int:
    """Smallest bucket holding ``n`` commands (callers chunk above the top
    bucket)."""
    buckets = get_buckets()
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def space_war_rows(rows: Sequence[Tuple[int, int, int]], locate,
                   primary: Tuple[bool, ...], total: Optional[int] = None
                   ) -> List[Tuple[int, int, int]]:
    """Insert ``OP_NOP`` spacer rows so no row writes a ``(pool, block)``
    the IMMEDIATELY preceding row reads (the reference's spacing rule,
    kept for journal parity).  ``total`` is the packed-src address-space
    size, so two-source bitwise rows space on either source."""
    out: List[Tuple[int, int, int]] = []
    prev_reads: Tuple = ()
    for row in rows:
        op, s, d = row
        if op < 0:
            out.append(row)
            prev_reads = ()
            continue
        reads, writes = row_rw(op, s, d, locate, total)
        if any(keys_clash(r, w, primary)
               for r in prev_reads for w in writes):
            out.append((OP_NOP, -1, -1))
        out.append(row)
        prev_reads = reads
    return out


@dataclasses.dataclass
class QueueStats:
    enqueued: int = 0
    flushes: int = 0           # explicit + boundary flushes that moved work
    hazard_flushes: int = 0    # forced early by a RAW/WAW ordering hazard
    war_hazards: int = 0       # WAR-on-source commands admitted (no flush)
    spacer_rows: int = 0       # OP_NOP spacers inserted
    launches: int = 0          # device launches issued for flushed tables
    retired: int = 0           # pending rows cancelled pre-flush (retire)
    max_pending: int = 0


class CommandQueue:
    """Accumulates ``(opcode, src, dst)`` commands for a RowCloneEngine and
    drains them through the engine's fused dispatch at flush time.

    Every :class:`~repro_torch.core.stream.CommandStream` wraps its own
    queue; the queue tracks pending sources and destinations so the engine
    can serialize cross-stream overlap and reason about in-flight reads
    (staging-slot lifetime)."""

    ALL_PRIMARY = ALL_PRIMARY

    def __init__(self, engine):
        # a weak proxy: the engine owns its queues, so `del engine` frees
        # the pools at once instead of at the next cycle collection
        self.engine = weakref.proxy(engine)
        self.stats = QueueStats()
        #: display name for journal records (CommandStream sets its own)
        self.name = "anon"
        self._cmds: List[Tuple[int, int, int]] = []
        # pending destination writes / source reads: block id -> set of
        # pool indices (ALL_PRIMARY = the block in every primary pool)
        self._pending_dsts: Dict[int, Set[int]] = {}
        self._pending_srcs: Dict[int, Set[int]] = {}
        # wall-clock of the oldest pending row (queue residency); None
        # while empty: armed on the first enqueue, popped by the drain
        self._first_enqueue_t: Optional[float] = None

    def pop_residency_us(self) -> float:
        """Microseconds the OLDEST pending row sat queued (0.0 when the
        clock is unarmed); read-and-reset, once per drain, so
        ``FlushTicket.timing.queue_residency_us`` measures first enqueue
        -> flush for each flush."""
        t0, self._first_enqueue_t = self._first_enqueue_t, None
        return 0.0 if t0 is None else (obs_metrics.now() - t0) * 1e6

    def __len__(self) -> int:
        return len(self._cmds)

    @property
    def pending(self) -> List[Tuple[int, int, int]]:
        """Copy of the not-yet-flushed ``(opcode, src, dst)`` rows."""
        return list(self._cmds)

    # ------------------------------------------------------------------
    def _hazard_keys(self, opcode: int, src: int, dst: int):
        """``(source_keys, dst_key)`` of one row, from the opcode registry."""
        group = self.engine.group
        reads, writes = row_rw(opcode, src, dst, group.locate,
                               group.total_blocks)
        return reads, writes[0]

    def _overlaps(self, key: Tuple[int, int],
                  pending: Dict[int, Set[int]]) -> bool:
        pool, block = key
        hit = pending.get(block)
        if hit is None:
            return False
        primary = self.engine.group.primary
        return any(keys_clash(key, (p, block), primary) for p in hit)

    def has_pending_write(self, key: Tuple[int, int]) -> bool:
        """Does ``(pool, block)`` overlap any pending destination write?"""
        return self._overlaps(key, self._pending_dsts)

    def has_pending_read(self, key: Tuple[int, int]) -> bool:
        """Does ``(pool, block)`` overlap any pending SOURCE read?"""
        return self._overlaps(key, self._pending_srcs)

    def _track(self, skeys, dkey) -> None:
        self._pending_dsts.setdefault(dkey[1], set()).add(dkey[0])
        for skey in skeys:
            self._pending_srcs.setdefault(skey[1], set()).add(skey[0])

    def enqueue(self, opcode: int, src: int, dst: int) -> None:
        """Append one tagged command.  RAW/WAW auto-flush first; WAR is
        admitted and counted.  Overlap with ANOTHER stream's pending
        commands drains that stream first (the engine's cross-stream
        guard)."""
        skeys, dkey = self._hazard_keys(opcode, src, dst)
        self.engine._cross_stream_guard(self, skeys, dkey)
        if any(self.has_pending_write(k) for k in skeys) \
                or self.has_pending_write(dkey):
            self.stats.hazard_flushes += 1
            obs_metrics.inc("queue.hazard_flushes", stream=self.name)
            self.flush()
        elif self.has_pending_read(dkey):
            self.stats.war_hazards += 1
            obs_metrics.inc("queue.war_hazards", stream=self.name)
        if self._first_enqueue_t is None:
            self._first_enqueue_t = obs_metrics.now()
        self._cmds.append((int(opcode), int(src), int(dst)))
        self._track(skeys, dkey)
        self.engine._note_pending(self)
        self.stats.enqueued += 1
        obs_metrics.inc("queue.enqueued", stream=self.name,
                        opcode=OPCODE_NAMES.get(int(opcode), str(opcode)))
        self.stats.max_pending = max(self.stats.max_pending, len(self._cmds))

    def enqueue_copy(self, opcode: int,
                     pairs: Sequence[Tuple[int, int]]) -> None:
        """Enqueue one copy command per ``(src, dst)`` pair under
        ``opcode``."""
        for s, d in pairs:
            self.enqueue(opcode, s, d)

    def enqueue_zero(self, ids: Sequence[int]) -> None:
        """Enqueue a BuZ zero-init (reserved-zero-row broadcast) per id."""
        for b in ids:
            self.enqueue(OP_ZERO_INIT, -1, b)

    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Drain every pending command.  Returns the device launches issued
        (0 when the queue was empty, 1 per bucket-padded chunk otherwise)."""
        if not self._cmds:
            return 0
        cmds, self._cmds = self._cmds, []
        self._pending_dsts = {}
        self._pending_srcs = {}
        self.engine._note_drained(self)
        launches = self.engine._drain_rows(cmds, queue=self)
        self.stats.flushes += 1
        self.stats.launches += launches
        self.engine._after_flush()
        return launches

    def retire(self, rows: Sequence[Tuple[int, int, int]]) -> int:
        """Cancel specific pending rows WITHOUT dispatching them (each
        requested row at most once); the hazard maps are rebuilt from the
        surviving rows.  Returns the number of rows removed."""
        want: Dict[Tuple[int, int, int], int] = {}
        for r in rows:
            r = (int(r[0]), int(r[1]), int(r[2]))
            want[r] = want.get(r, 0) + 1
        kept: List[Tuple[int, int, int]] = []
        removed = 0
        for row in self._cmds:
            if want.get(row, 0) > 0:
                want[row] -= 1
                removed += 1
            else:
                kept.append(row)
        if not removed:
            return 0
        self._cmds = kept
        self._pending_dsts = {}
        self._pending_srcs = {}
        for op, s, d in kept:
            self._track(*self._hazard_keys(op, s, d))
        self.stats.retired += removed
        obs_metrics.inc("queue.retired", removed, stream=self.name)
        if not kept:
            self._first_enqueue_t = None
            self.engine._note_drained(self)
        return removed

    def abort(self) -> List[Tuple[int, int, int]]:
        """Discard every pending command WITHOUT dispatching: the hazard
        maps clear and the queue leaves the engine's live set.  Returns
        the dropped rows, for the caller to account for or re-enqueue
        (:meth:`~repro_torch.core.stream.CommandStream.adopt`)."""
        cmds, self._cmds = self._cmds, []
        self._pending_dsts = {}
        self._pending_srcs = {}
        self._first_enqueue_t = None
        self.engine._note_drained(self)
        return cmds


__all__ = ["BUCKETS", "DEFAULT_BUCKETS", "set_buckets", "get_buckets",
           "top_bucket", "bucket_size", "space_war_rows",
           "QueueStats", "CommandQueue"]
