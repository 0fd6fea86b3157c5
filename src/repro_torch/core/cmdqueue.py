"""CommandQueue — the memory-controller command buffer for bulk movement.

The port's copy of ``repro/core/cmdqueue.py``.  Callers enqueue tagged
``(opcode, src, dst)`` rows; the device sees work only at flush
boundaries, where the whole table drains as ONE fused launch over every
pool (kernels/fused_dispatch.py), or, on an engine over a rank mesh, as
one sharded drain of the :class:`ShardPlan` that
:func:`partition_commands` makes of it.  Tables pad to the
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
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.opcodes import (ALL_PRIMARY, OP_CROSS_POOL_COPY,
                                      OP_NOP, OP_NOT, OP_ZERO_INIT,
                                      OPCODE_NAMES, keys_clash, opspec,
                                      pack_bitwise_src, row_rw,
                                      unpack_bitwise_src)
from repro_torch.core.poolspec import PoolGroup
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


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A flushed command table, partitioned for one sharded drain over a
    rank mesh (the reference's ``ShardPlan``, field for field).

    Produced on the host by :func:`partition_commands`; consumed by
    ``kernels/fused_dispatch.py sharded_fused_dispatch``.  Every shard's
    sub-table pads to the largest shard's occupancy (bucketed like a
    flush), as the reference's one ``shard_map`` launch needs.

    Each pool partitions by its **own** shard size (``nblk_p // S`` — the
    per-pool block counts come from the engine's PoolGroup, so a small
    staging ring and a large KV pool split into the same shard count with
    different per-shard slab sizes):

    * ``local_tables`` (S, m, 3) int32 ``[opcode, src, dst]`` rows with
      **slab-local** block ids; ``CROSS_POOL_COPY`` ids re-stack with the
      slab-local prefix-sum bases (``local_base[p] + local``, where
      ``local_base`` runs over ``shard_sizes``) so the per-shard drain
      decodes them from its own slab shapes; ``OP_NOP`` rows pad.
    * The send/recv plan covers every cross-slab command, grouped by hop
      distance ``delta = (dst_shard - src_shard) mod S`` (K7's hop):
      sender ``i``'s slot ``j`` for a given delta pairs with receiver
      ``(i + delta) mod S``'s slot ``j``.
      - ``send_rows`` (K, S, t): *pool-local* slab row each sender gathers
        (every pool is gathered at that row; the receiver picks the buffer
        that matters; -1 pads).
      - ``recv_tables`` (K, S, t, 4): ``[buf_pool, dst_pool, dst_row,
        combine_op]`` — ``buf_pool``/``dst_pool`` are -1 for whole-block
        copies (each pool scatters its own buffer slot); a cross-pool
        transfer names the source-pool buffer and destination pool;
        ``dst_row`` is pool-local in the destination slab; -1 pads.
        ``combine_op`` orders two-source bitwise rows whose sources are
        not resident on the destination shard: -1 is a plain overwrite
        (phase 0 of the scatter), ``OP_NOT`` overwrites with the inverted
        buffer (phase 0), and ``OP_AND``/``OP_OR`` fold the buffer into
        the already-landed destination block (phase 1) — such a row ships
        one entry per non-resident source (srcA as the overwrite, srcB as
        the combine, hop distance 0 allowed when only one side travels).
    """
    n_shards: int
    shard_sizes: Tuple[int, ...]  # per-pool slab size (nblk_p / S)
    n_local: int                 # commands drained inside their own slab
    n_transfer: int              # commands crossing a slab boundary
    n_spacers: int               # per-slab WAR spacer rows inserted
    local_tables: np.ndarray     # (S, m, 3) int32
    deltas: Tuple[int, ...]      # hop distances, sorted
    send_rows: np.ndarray        # (K, S, t) int32
    recv_tables: np.ndarray      # (K, S, t, 4) int32


def partition_commands(rows: Iterable[Tuple[int, int, int]], *,
                       n_shards: int, group: PoolGroup,
                       replicated: Optional[Tuple[bool, ...]] = None
                       ) -> ShardPlan:
    """Split one flushed (hazard-free) command table into per-slab
    sub-tables plus a cross-slab send/recv plan.

    Classification is by **device shard** (``block_id // shard_size``,
    with each pool's own shard size — a staging ring shards into smaller
    slabs than its KV pool), not by the opcode's mechanism tag: an
    ``OP_FPM_COPY`` whose allocator slabs are finer than the device
    sharding may still cross a shard boundary, and an ``OP_PSM_COPY``
    between allocator slabs co-resident on one device drains locally.
    Plain-opcode ids live in the primary address space (every primary pool
    shares one block count); ``OP_CROSS_POOL_COPY`` ids are global
    ``group.base(pool) + block`` and are resolved through ``group``.
    Enqueue order is preserved within each shard's sub-table (each
    sub-table is then WAR-spaced, :func:`space_war_rows`); the flush
    hazard guards make the cross-shard interleaving (read transfer
    sources, drain local tables, hop and land) equivalent to the
    sequential drain.

    ``replicated[p]`` marks pools whose block axis is NOT device-sharded
    (``PoolSpec.sharding == ()`` — e.g. a staging ring held whole on
    every device): their slab is the full pool (``shard_sizes[p] ==
    nblk_p``), a cross-pool read from them is always local to the
    destination's shard, and a replicated→replicated copy lands in EVERY
    shard's sub-table so the replicas stay consistent.  A cross-pool
    WRITE into a replicated pool from a sharded source would need a
    broadcast hop and raises; the engine degrades that flush to the
    fan-out."""
    if replicated is None:
        replicated = tuple([False] * len(group))
    for i, spec in enumerate(group):
        if replicated[i]:
            if spec.role == "primary":
                raise ValueError(
                    f"primary pool {spec.name!r} cannot be replicated: "
                    "plain opcodes partition by the primary shard size")
            continue
        if spec.nblk % n_shards:
            raise ValueError(f"pool {spec.name!r}: nblk={spec.nblk} not "
                             f"divisible by {n_shards} shards")
    ss = tuple(spec.nblk if replicated[i] else spec.nblk // n_shards
               for i, spec in enumerate(group))
    # slab-local prefix-sum bases: the per-shard stacked address space
    local_base = []
    run = 0
    for s_p in ss:
        local_base.append(run)
        run += s_p
    p0 = group.primary.index(True)  # plain ops address the primary space
    ss0 = ss[p0]
    lt = run                        # slab-local stacked total (bitwise pack)
    local: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_shards)]
    # delta -> per-src-shard slot lists of (src_row, buf_pool, dst_pool,
    # dst_row, combine_op)
    xfer: Dict[int, List[List[Tuple[int, int, int, int, int]]]] = {}
    n_transfer = 0

    def _side(p: int, blk: int, sh_d: int) -> Tuple[int, int, int]:
        """Resolve one source of a bitwise row against the dst shard:
        ``(shard, slab_local_gid, slab_pool_row)`` — replicated pools are
        resident everywhere, so they count as the dst shard."""
        if replicated[p]:
            return sh_d, local_base[p] + blk, blk
        return blk // ss[p], local_base[p] + blk % ss[p], blk % ss[p]

    def _xfer_entry(delta: int, sh_s: int, entry: Tuple[int, int, int,
                                                        int, int]) -> None:
        slots = xfer.setdefault(delta, [[] for _ in range(n_shards)])
        slots[sh_s].append(entry)

    for op, s, d in rows:
        if op < 0:
            continue
        # classification derives from the opcode's registry contract
        # (core/opcodes.py): source-less rows are always slab-local,
        # two-source compute rows split per travelling source, global-id
        # rows resolve through the group, primary-space rows through ss0
        sp = opspec(op)
        if sp.src_kind == "none":
            local[d // ss0].append((op, -1, d % ss0))
            continue
        if sp.is_compute:
            a, b = unpack_bitwise_src(s, group.total_blocks)
            pa, ab = group.locate(a)
            pb, bb = group.locate(b)
            pd, bd = group.locate(d)
            if replicated[pd]:
                if not (replicated[pa] and replicated[pb]):
                    raise ValueError(
                        f"bitwise write into replicated pool "
                        f"{group[pd].name!r} from a sharded source needs "
                        "a broadcast hop (unsupported in the sharded "
                        "drain)")
                row = (op, pack_bitwise_src(local_base[pa] + ab,
                                            local_base[pb] + bb, lt),
                       local_base[pd] + bd)
                for sh in range(n_shards):
                    local[sh].append(row)
                continue
            sh_d = bd // ss[pd]
            ld = bd % ss[pd]
            sh_a, la, ra = _side(pa, ab, sh_d)
            sh_b, lb, rb = _side(pb, bb, sh_d)
            if sh_a == sh_d and sh_b == sh_d:
                local[sh_d].append(
                    (op, pack_bitwise_src(la, lb, lt), local_base[pd] + ld))
                continue
            # a two-source row with any non-resident source ships ONE
            # transfer entry per travelling source: srcA lands first
            # (overwrite / inverted overwrite), srcB folds in during the
            # combine phase — a resident srcA instead becomes a local
            # cross-pool copy (drained before any scatter), a resident
            # srcB a hop-distance-0 combine entry
            if op == OP_NOT:
                _xfer_entry((sh_d - sh_a) % n_shards, sh_a,
                            (ra, pa, pd, ld, OP_NOT))
                n_transfer += 1
                continue
            if sh_a == sh_d:
                local[sh_d].append((OP_CROSS_POOL_COPY, la,
                                    local_base[pd] + ld))
            else:
                _xfer_entry((sh_d - sh_a) % n_shards, sh_a,
                            (ra, pa, pd, ld, -1))
                n_transfer += 1
            _xfer_entry((sh_d - sh_b) % n_shards, sh_b,
                        (rb, pb, pd, ld, op))
            n_transfer += 1
            continue
        if sp.src_kind == "global":
            ps, bs = group.locate(s)
            pd, bd = group.locate(d)
            if replicated[pd]:
                if not replicated[ps]:
                    raise ValueError(
                        f"cross-pool write into replicated pool "
                        f"{group[pd].name!r} from sharded "
                        f"{group[ps].name!r} needs a broadcast hop "
                        "(unsupported in the sharded drain)")
                # replicated→replicated: every shard applies the same
                # copy to its replica
                row = (op, local_base[ps] + bs, local_base[pd] + bd)
                for sh in range(n_shards):
                    local[sh].append(row)
                continue
            if replicated[ps]:
                # replicated source: the bytes are resident on the
                # destination's shard — always a local row there
                local[bd // ss[pd]].append(
                    (op, local_base[ps] + bs,
                     local_base[pd] + bd % ss[pd]))
                continue
            sh_s, sh_d = bs // ss[ps], bd // ss[pd]
            if sh_s == sh_d:
                local[sh_d].append((op, local_base[ps] + bs % ss[ps],
                                    local_base[pd] + bd % ss[pd]))
                continue
            entry = (bs % ss[ps], ps, pd, bd % ss[pd], -1)
        else:
            sh_s, sh_d = s // ss0, d // ss0
            if sh_s == sh_d:
                local[sh_d].append((op, s % ss0, d % ss0))
                continue
            entry = (s % ss0, -1, -1, d % ss0, -1)
        _xfer_entry((sh_d - sh_s) % n_shards, sh_s, entry)
        n_transfer += 1

    n_local = sum(len(l) for l in local)

    # per-slab WAR spacing for the overlapped per-shard kernel drain:
    # adjacency is a property of each drained sub-table, so the spacing
    # re-runs here against the slab-local stacked address space
    def _local_locate(gid: int) -> Tuple[int, int]:
        for i in range(len(ss) - 1, -1, -1):
            if gid >= local_base[i]:
                return i, gid - local_base[i]
        raise AssertionError("unreachable")

    pre_spacing = sum(len(l) for l in local)
    local = [space_war_rows(l, _local_locate, group.primary, lt)
             for l in local]
    n_spacers = sum(len(l) for l in local) - pre_spacing
    longest = max((len(l) for l in local), default=0) or 1
    m = bucket_size(longest)
    while m < longest:   # spacers can push a dense slab past the top
        m *= 2           # bucket; grow by powers of two (rare, still one
    # static shape per flush)
    local_tables = np.full((n_shards, m, 3), OP_NOP, np.int32)
    for sh, cmds in enumerate(local):
        if cmds:
            local_tables[sh, :len(cmds)] = np.asarray(cmds, np.int32)

    deltas = tuple(sorted(xfer))
    t = bucket_size(max((len(per_src)
                         for slots in xfer.values() for per_src in slots),
                        default=0) or 1) if deltas else 0
    send_rows = np.full((len(deltas), n_shards, max(t, 1)), -1, np.int32)
    recv_tables = np.full((len(deltas), n_shards, max(t, 1), 4), -1, np.int32)
    for k, delta in enumerate(deltas):
        for sh_s, entries in enumerate(xfer[delta]):
            sh_d = (sh_s + delta) % n_shards
            for j, (src_row, ps, pd, dst_row, comb) in enumerate(entries):
                send_rows[k, sh_s, j] = src_row
                recv_tables[k, sh_d, j] = (ps, pd, dst_row, comb)
    return ShardPlan(n_shards=n_shards, shard_sizes=ss, n_local=n_local,
                     n_transfer=n_transfer, n_spacers=n_spacers,
                     local_tables=local_tables, deltas=deltas,
                     send_rows=send_rows, recv_tables=recv_tables)


def fold_shard_plan(plan: ShardPlan) -> ShardPlan:
    """Re-express a plan over the FULL delta set ``(1 .. S-1)``.

    Every hop distance gets a (possibly all-padding) send/recv table of
    the plan's existing slot bucket, so the plan's signature collapses to
    one per ``t`` bucket whatever delta subset a flush uses.  The
    signature bound (kernels/fused_dispatch.py) applies this past a
    threshold of distinct ``(deltas, t)`` signatures, as the reference's
    jit-cache bound does; the added tables are padding and move nothing."""
    S = plan.n_shards
    # hop distance 0 (a resident srcB folding into a travelled srcA) only
    # exists when a flush used it — fold onto 1..S-1 plus 0 when present
    full = tuple(sorted(set(range(1, S)) | set(plan.deltas)))
    if plan.deltas == full or not plan.deltas:
        return plan
    idx = {delta: k for k, delta in enumerate(full)}
    t = plan.send_rows.shape[2]
    send = np.full((len(full), S, t), -1, np.int32)
    recv = np.full((len(full), S, t, 4), -1, np.int32)
    for k, delta in enumerate(plan.deltas):
        send[idx[delta]] = plan.send_rows[k]
        recv[idx[delta]] = plan.recv_tables[k]
    return dataclasses.replace(plan, deltas=full, send_rows=send,
                               recv_tables=recv)


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
           "top_bucket", "bucket_size", "space_war_rows", "ShardPlan",
           "partition_commands", "fold_shard_plan", "QueueStats",
           "CommandQueue"]
