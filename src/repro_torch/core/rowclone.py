"""RowCloneEngine — the ``memcopy``/``meminit`` "ISA" and its dispatcher
(port of ``repro/core/rowclone.py``).

* ``memcopy(pairs)`` classifies each (src, dst) pair: ``alias`` (the source
  is lazily zero under ZI: a metadata move, zero bytes), ``fpm`` (same
  slab), ``psm`` (cross slab) or ``baseline`` (RowClone disabled), and
  enqueues the tagged row;
* ``meminit(ids)`` sets the ZI lazy-zero bit, or enqueues BuZ zero rows;
* ``memcopy_cross`` / ``promote_staged`` move blocks between pools by
  global ``base[pool] + block`` id (the :class:`PoolGroup` address space);
* ``memand`` / ``memor`` / ``memnot`` compute on raw bits in place;
* ``demote_to_spill`` / ``promote_spilled`` park primary blocks in the
  spill pools and bring them back (preemption), and ``set_stage_limit``
  clamps the staging ring (the serving layer's adaptive ring).

Dispatch is queued and fused: at a flush boundary the whole table drains
as ONE launch moving every pool (kernels/fused_dispatch.py).
``use_fused=False`` drains it instead through the per-mechanism fan-out
(the A/B leg the fused drain is measured against): one call per run of
one opcode, per ``max_requests`` chunk, per pool — FPM rows through K5a,
cross-pool rows through K5b, zero rows through K6, PSM rows through K7
(one rank, hop 0), and baseline and bitwise rows as plain tensor code
(jnp, not Pallas, in the JAX package).
The pools are torch tensors updated IN PLACE where the JAX engine donated
them; each in-place write bumps the pool's generation, which is how a
:class:`~repro_torch.core.stream.FlushTicket` knows it expired.

``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh` of more than one
rank) holds every pool as one slab per rank on that rank's device, a
replicated pool (``PoolSpec.sharding == ()``) whole on every rank.  A
flush then drains as ONE sharded drain of its ``ShardPlan``
(``_dispatch_sharded``: K7 hops, K1 per rank), and the fan-out runs per
rank (K5a / K5b for blocks that stay on a rank, K7 for blocks that change
rank and for every PSM pair, K6 for zero rows).  ``engine.pools`` then
reads each pool back whole (:class:`MeshPools`).

Every drain runs inside a ``"drain"`` span (obs/trace.py), leaves its
:class:`~repro_torch.obs.trace.FlushTiming` on ``last_drain_timing`` and
emits the reference's ``drain.*`` series; the verbs emit
``engine.bytes_moved`` / ``engine.bytes_avoided``.  ``sanitize`` attaches
the drain sanitizer (core/sanitizer.py).
"""
from __future__ import annotations

import collections.abc
import contextlib
import dataclasses
import functools
import itertools
import time
import warnings
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.cmdqueue import (CommandQueue, bucket_size,
                                       partition_commands, space_war_rows,
                                       top_bucket)
from repro_torch.core.journal import (AbortedFlush, JournalRecord,
                                      PoolSnapshot, RecoveryError,
                                      RecoveryReport, TicketJournal,
                                      from_host, to_host)
from repro_torch.core.opcodes import (ALL_PRIMARY, BITWISE_OPS, OP_AND,
                                      OP_BASELINE_COPY, OP_CROSS_POOL_COPY,
                                      OP_FPM_COPY, OP_NOP, OP_NOT, OP_OR,
                                      OP_PSM_COPY, OP_ZERO_INIT,
                                      OPCODE_NAMES, check_pack_total, opspec,
                                      pack_bitwise_src, row_rw,
                                      unpack_bitwise_src)
from repro_torch.core.poolspec import BlockRef, PoolGroup
from repro_torch.core.sanitizer import DrainSanitizer, sanitize_enabled
from repro_torch.core.stream import CommandStream
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.fpm_copy import _live_pairs, pair_waves
from repro_torch.kernels.fused_dispatch import (DrainInfo, check_drain,
                                                notify_launch)
from repro_torch.launch.mesh import (DeviceMesh, pool_partition_spec,
                                     pool_shard_axes, pool_shard_count,
                                     pool_shard_ranks)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.autotune import backend_key, load_profile
from repro_torch.obs.trace import FlushTiming, span


@dataclasses.dataclass
class EngineStats:
    fpm_copies: int = 0
    psm_copies: int = 0
    alias_copies: int = 0
    baseline_copies: int = 0
    cross_pool_copies: int = 0
    stage_promotions: int = 0   # staged blocks promoted into primary pools
    retired_promotions: int = 0  # queued promotions cancelled pre-flush
    demotions: int = 0          # primary blocks parked in spill slots
    spill_promotions: int = 0   # spill slots promoted back into primaries
    zero_lazy: int = 0
    zero_materialized: int = 0
    bytes_fpm: int = 0
    bytes_psm: int = 0
    bytes_baseline: int = 0
    bytes_cross: int = 0
    bytes_avoided: int = 0      # alias + lazy zero
    cross_stream_flushes: int = 0  # streams serialized by an overlap
    launches: int = 0           # device dispatches issued for bulk movement
    bitwise_ops: int = 0        # AND/OR/NOT compute rows enqueued
    bytes_bitwise: int = 0      # destination bytes written by bitwise rows


class RowCloneEngine:
    """Owns block pools + allocator; dispatches copy/init requests.

    ``pools`` maps name -> tensor ``(nblk_p, ...)`` (``block_axis=0``) or
    layer-stacked ``(L, nblk_p, ...)`` (``block_axis=1``), all on one
    device (without a mesh).  ``staging`` maps a staging pool to its
    primary twin, or ``group`` gives the :class:`PoolGroup` directly.
    Primary pools share the allocator's block count; staging pools may be
    any size (one shared slot space) and mirror their twin's block shape
    and dtype.

    ``use_fused=False`` selects the per-mechanism fan-out drain, each call
    padded to ``max_requests`` rows.

    ``mesh``: a :class:`~repro_torch.launch.mesh.DeviceMesh` whose axes
    are pool axes.  With more than one rank the given (whole) pools are
    split into per-rank slabs on the ranks' devices: a pool of ``nblk``
    blocks into slabs of ``ceil(nblk / S)`` (the last ones shorter when
    ``S`` does not divide ``nblk``; such a pool degrades every flush to
    the fan-out, with one warning), a pool whose ``sharding`` hint is
    ``()`` into ``S`` whole replicas.  ``engine.pools`` is then a
    :class:`MeshPools`: reading a pool gathers it whole, assigning one
    scatters it.  A mesh of one rank is one device.

    ``sanitize`` attaches a :class:`~repro_torch.core.sanitizer
    .DrainSanitizer` (``None``: the ``REPRO_SANITIZE`` environment
    variable decides): every chunk is checked against the opcode contract
    before its launch and shadow-drained by the plain version after it;
    it issues no launches.

    The reference's ``overlap`` argument (its overlapped-DMA toggle) has
    no counterpart: K1's waves take the place of the TPU's depth-2 drain
    (kernels/fused_dispatch.py), so a profile's ``overlap`` field is read
    and written but applies to nothing."""

    def __init__(self, pools: Dict[str, torch.Tensor],
                 allocator: SubarrayAllocator, *,
                 mesh: Optional[DeviceMesh] = None, enable_fpm: bool = True,
                 enable_psm: bool = True, enable_zi: bool = True,
                 max_requests: int = 256, block_axis: int = 0,
                 use_fused: bool = True,
                 staging: Optional[Dict[str, str]] = None,
                 group: Optional[PoolGroup] = None,
                 sanitize: Optional[bool] = None):
        self.alloc = allocator
        self.enable_fpm = enable_fpm
        self.enable_psm = enable_psm
        self.enable_zi = enable_zi
        self.max_requests = max_requests
        self.block_axis = block_axis
        self.use_fused = use_fused
        if group is None:
            group = PoolGroup.from_pools(pools, block_axis=block_axis,
                                         staging=staging)
        if set(group.names) != set(pools):
            raise ValueError(f"pool group {group.names} does not match "
                             f"pools {list(pools)}")
        self.group = group
        self.staging = dict(group.staging_map)
        self.mesh = mesh
        self.pools = {name: pools[name] for name in group.names}
        if mesh is not None and mesh.size == 1:
            self.pools = {n: p.to(mesh.devices[0])
                          for n, p in self.pools.items()}
        devices = {p.device for p in self.pools.values()}
        if len(devices) != 1 and not self._multi_device():
            raise ValueError(f"pools span devices {devices}")
        self.device = mesh.devices[pool_shard_ranks(mesh)[0]] \
            if self._multi_device() else devices.pop()
        #: this backend's TunedProfile, or None (obs/autotune.py)
        self.profile = load_profile(backend_key(self.device))
        #: FlushTiming of the most recent drain (FlushTicket.timing source)
        self.last_drain_timing: Optional[FlushTiming] = None
        #: per-pool count of in-place writes (drains and out-of-band)
        self.pool_generation: Dict[str, int] = {n: 0 for n in self.pools}
        self.stats = EngineStats()
        for spec in group:
            p = self.pools[spec.name]
            if p.shape[block_axis] != spec.nblk:
                raise ValueError(f"pool {spec.name!r}: {p.shape[block_axis]}"
                                 f" blocks != spec nblk {spec.nblk}")
            if spec.role == "primary" and spec.nblk != allocator.num_blocks:
                raise ValueError(f"primary pool {spec.name!r}: {spec.nblk} "
                                 f"blocks != allocator's "
                                 f"{allocator.num_blocks}")
        stage_cap = 0
        for sname, pname in self.staging.items():
            s, p = self.pools[sname], self.pools[pname]
            if self._block_shape(s) != self._block_shape(p) \
                    or s.dtype != p.dtype:
                raise ValueError(f"staging pool {sname!r} must mirror "
                                 f"{pname!r}'s block shape and dtype")
            cap = s.shape[block_axis]
            if stage_cap not in (0, cap):
                raise ValueError("staging pools must share one block count")
            stage_cap = cap
        for spec in group:
            if spec.role == "spill" and (
                    self._block_shape(self.pools[spec.name])
                    != self._block_shape(self.pools[spec.paired])
                    or self.pools[spec.name].dtype
                    != self.pools[spec.paired].dtype):
                raise ValueError(f"spill pool {spec.name!r} must mirror "
                                 f"{spec.paired!r}'s block shape and dtype")
        self._live_queues: Dict[int, CommandQueue] = {}
        self._stream_count = 0
        self._default_stream = CommandStream(self, "default")
        self._cur_queue = self._default_stream.queue
        self.deferred = False
        self._zero_blocks: Optional[Tuple[torch.Tensor, ...]] = None
        # staging slot free list, slots whose promotion is still queued
        # (reclaimed once no stream holds a pending READ of them), and
        # free slots parked above the adaptive ring limit
        self._stage_free: List[int] = list(range(stage_cap - 1, -1, -1))
        self._stage_inflight: List[int] = []
        self._stage_parked: List[int] = []
        self._stage_limit: Optional[int] = None
        # demotion: primary pool -> its spill twin, and the engine-owned
        # demotion slot space handed over by enable_demotion
        self._spill_map: Dict[str, str] = {
            spec.paired: spec.name for spec in group if spec.role == "spill"}
        self._spill_slots: Tuple[int, ...] = ()
        self._spill_free: List[int] = []
        self._spill_inflight: List[int] = []
        # a degraded recover()'s sticky ring cap: the adaptive ring may
        # shrink below it, but regrowing on demand never exceeds it
        self._stage_degraded_cap: Optional[int] = None
        #: replayable log of drained flushes
        self.journal = TicketJournal()
        self._flush_index = 0
        #: undispatched suffixes of failed flushes, for recover()
        self._aborted: List[AbortedFlush] = []
        # each pool's (shape, dtype), frozen so recover() can resurrect or
        # restore a killed pool
        self._pool_layouts = {name: (tuple(p.shape), p.dtype)
                              for name, p in self.pools.items()}
        #: per pool, its slab on each rank (shard order), under a mesh
        self._slabs: Optional[Dict[str, List[torch.Tensor]]] = None
        self._warned_unshardable = False
        #: (n_shards, deltas, slots) of the last sharded drain's plan
        self._last_plan_sig: Optional[Tuple] = None
        if self._multi_device():
            self._split_into_slabs()
        if sanitize is None:
            sanitize = sanitize_enabled()
        #: the attached drain sanitizer, or None (core/sanitizer.py)
        self.sanitizer: Optional[DrainSanitizer] = \
            DrainSanitizer(self) if sanitize else None

    def _block_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        shape = list(p.shape)
        shape.pop(self.block_axis)
        return tuple(shape)

    # ------------------------------------------------------------------
    # the rank mesh: per-rank slabs
    # ------------------------------------------------------------------
    def _multi_device(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def n_shards(self) -> int:
        """Ranks each sharded pool splits over (1 without a mesh)."""
        return pool_shard_count(self.mesh) if self._multi_device() else 1

    def _pool_replicated(self) -> Tuple[bool, ...]:
        """Per-pool replication vector from the ``PoolSpec.sharding``
        hints: ``()`` holds the pool whole on every rank."""
        return tuple(s.sharding == () for s in self.group)

    def _slab_size(self, p: int) -> int:
        """Blocks of pool ``p``'s slab on rank 0 (every rank but the last
        ones of a ragged pool)."""
        nblk = self.group[p].nblk
        if self._pool_replicated()[p]:
            return nblk
        return -(-nblk // self.n_shards)

    def _slab_range(self, p: int, rank: int) -> Tuple[int, int]:
        """(first block, blocks) of pool ``p`` held by ``rank``."""
        nblk, ss = self.group[p].nblk, self._slab_size(p)
        if self._pool_replicated()[p]:
            return 0, nblk
        start = min(rank * ss, nblk)
        return start, min(ss, nblk - start)

    def _split_into_slabs(self) -> None:
        """Move the given whole pools into per-rank slabs."""
        for spec in self.group:
            axes = pool_partition_spec(self.mesh, spec)[-1]
            if spec.sharding != () and axes != pool_shard_axes(self.mesh):
                raise ValueError(
                    f"pool {spec.name!r}: sharding {spec.sharding} over part "
                    "of the mesh is not ported (the joint pool axes or ())")
        devs = [self.mesh.devices[r] for r in pool_shard_ranks(self.mesh)]
        self._shard_devices = devs
        self._slabs = {n: [] for n in self.group.names}
        whole, self.pools = self.pools, MeshPools(self)
        for name in self.group.names:
            self._scatter(name, whole[name])

    def _scatter(self, name: str, t: torch.Tensor) -> None:
        """Write the whole pool ``t`` into ``name``'s slabs: in place where
        every slab is alive, as fresh slabs otherwise (recover)."""
        p = self.group.index(name)
        ba = self.block_axis
        old = self._slabs[name]
        live = len(old) == self.n_shards and \
            not any(kref.pool_dead(x) for x in old)
        new = []
        for r, dev in enumerate(self._shard_devices):
            start, n = self._slab_range(p, r)
            piece = t.narrow(ba, start, n)
            if live:
                old[r].copy_(piece)
            else:
                new.append(piece.to(dev, copy=True).contiguous())
        if not live:
            self._slabs[name] = new

    def _gather(self, name: str) -> torch.Tensor:
        """A copy of the whole pool ``name`` on the engine's device."""
        slabs = self._slabs[name]
        if any(kref.pool_dead(x) for x in slabs):
            raise RuntimeError(f"pool {name!r} has no storage (killed): "
                               "recover() restores it")
        if self._pool_replicated()[self.group.index(name)]:
            return slabs[0].to(self.device, copy=True)
        return torch.cat([x.to(self.device) for x in slabs], self.block_axis)

    def slabs(self, name: str) -> List[torch.Tensor]:
        """Pool ``name``'s slab on each rank, in shard order (the live
        storage under a mesh; the whole pool alone without one)."""
        if self._slabs is None:
            return [self.pools[name]]
        return list(self._slabs[name])

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices that hold the pools: the engine's device,
        or under a mesh every rank's device, in shard order."""
        if self._slabs is None:
            return (self.device,)
        return tuple(dict.fromkeys(self._shard_devices))

    def block(self, name: str, b: int) -> torch.Tensor:
        """Block ``b`` of pool ``name`` as a view of the storage that holds
        it (under a mesh, of its slab; a replicated pool's rank-0
        replica)."""
        ba = self.block_axis
        if self._slabs is None:
            return self.pools[name].select(ba, b)
        rank, lb = self._read_at(self.group.index(name), int(b), 0)
        return self._slabs[name][rank].select(ba, lb)

    def write_blocks(self, name: str, ids: Sequence[int],
                     pages: torch.Tensor) -> None:
        """Write ``pages`` (pool ``name``'s layout with ``len(ids)`` blocks
        on the block axis) into its blocks ``ids``, in place and outside
        the command queue (the serving layer's prefill writes).  Under a
        mesh each page goes into the slab that holds its block, and into
        every replica of a replicated pool (:meth:`_write_at`): a write
        into ``engine.pools[name]`` would land in a gathered copy.
        Tickets that describe the pool expire."""
        ba = self.block_axis
        ids = [int(b) for b in ids]
        if self._slabs is None:
            pool = self.pools[name]
            pool.index_copy_(ba, torch.as_tensor(ids, device=pool.device),
                             pages.to(pool.device))
        else:
            p = self.group.index(name)
            by_rank: Dict[int, Tuple[List[int], List[int]]] = {}
            for j, b in enumerate(ids):
                for rank, lb in self._write_at(p, b):
                    src, dst = by_rank.setdefault(rank, ([], []))
                    src.append(j)
                    dst.append(lb)
            for rank, (src, dst) in by_rank.items():
                slab = self._slabs[name][rank]
                part = pages.index_select(
                    ba, torch.as_tensor(src, device=pages.device))
                slab.index_copy_(ba, torch.as_tensor(dst, device=slab.device),
                                 part.to(slab.device))
        self.mark_pools_written((name,))

    def pool_is_dead(self, name: str) -> bool:
        """Was pool ``name`` killed (:meth:`kill_pool`) and not yet
        recovered?"""
        if self._slabs is None:
            return kref.pool_dead(self.pools[name])
        return any(kref.pool_dead(x) for x in self._slabs[name])

    def _read_at(self, p: int, blk: int, rank: int) -> Tuple[int, int]:
        """(rank, slab block) to read block ``blk`` of pool ``p`` from for
        a write on ``rank``: a replica is read where it is written."""
        if self._pool_replicated()[p]:
            return rank, blk
        ss = self._slab_size(p)
        return blk // ss, blk % ss

    def _write_at(self, p: int, blk: int) -> List[Tuple[int, int]]:
        """Every (rank, slab block) that holds block ``blk`` of pool
        ``p``: one, or every rank's replica."""
        if self._pool_replicated()[p]:
            return [(r, blk) for r in range(self.n_shards)]
        ss = self._slab_size(p)
        return [(blk // ss, blk % ss)]

    # ------------------------------------------------------------------
    # streams
    # ------------------------------------------------------------------
    def _note_pending(self, queue: CommandQueue) -> None:
        self._live_queues[id(queue)] = queue

    def _note_drained(self, queue: CommandQueue) -> None:
        self._live_queues.pop(id(queue), None)

    def stream(self, name: Optional[str] = None) -> CommandStream:
        """Mint a new ordered :class:`CommandStream` on this engine."""
        self._stream_count += 1
        if name is None:
            name = f"stream{self._stream_count}"
        return CommandStream(self, name)

    @property
    def queue(self) -> CommandQueue:
        """The DEFAULT stream's command queue."""
        return self._default_stream.queue

    def _cross_stream_guard(self, queue: CommandQueue, skeys, dkey) -> None:
        """A command about to land on ``queue`` that reads or writes
        another stream's pending WRITE, or writes another stream's pending
        READ, drains that other stream first."""
        for q in list(self._live_queues.values()):
            if q is queue or not len(q):
                continue
            if q.has_pending_write(dkey) or q.has_pending_read(dkey) \
                    or any(q.has_pending_write(k) for k in skeys):
                self.stats.cross_stream_flushes += 1
                q.flush()

    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        """Blocks per PRIMARY pool (the allocator's address space)."""
        return self.alloc.num_blocks

    @property
    def stage_capacity(self) -> int:
        """Staging slot ids available per staging pool (0 = no staging)."""
        return self.group[next(iter(self.staging))].nblk if self.staging \
            else 0

    @property
    def stage_slots_free(self) -> int:
        """Staging slots currently on the free list (slots whose
        promotion is still queued, and slots parked above the ring limit,
        are not)."""
        return len(self._stage_free)

    @property
    def stage_limit(self) -> Optional[int]:
        """The adaptive ring clamp: usable slots are ids ``<
        stage_limit``.  None = full capacity."""
        return self._stage_limit

    def set_stage_limit(self, limit: Optional[int]) -> int:
        """Clamp the staging ring to ``limit`` usable slots (ids below
        it); FREE slots at or above it park until the limit is raised, so
        reserved and in-flight slots are untouched.  ``None`` (or a limit
        >= :attr:`stage_capacity`) restores the full ring.  Returns the
        usable-slot count."""
        cap = self.stage_capacity
        if limit is None or int(limit) >= cap:
            self._stage_limit = None
            self._stage_free.extend(self._stage_parked)
            self._stage_parked = []
            effective = cap
        else:
            lim = max(int(limit), 0)
            self._stage_limit = lim
            usable = [s for s in self._stage_free if s < lim] + \
                [s for s in self._stage_parked if s < lim]
            parked = [s for s in self._stage_free if s >= lim] + \
                [s for s in self._stage_parked if s >= lim]
            self._stage_free = usable
            self._stage_parked = parked
            effective = lim
        obs_metrics.set_gauge("engine.stage_limit", effective)
        return effective

    def _reclaim_stage_slots(self, slots: Sequence[int]) -> None:
        """Freed staging slots join the free list, or the parked list
        when the ring limit excludes their ids."""
        lim = self._stage_limit
        if lim is None:
            self._stage_free.extend(slots)
            return
        for s in slots:
            (self._stage_free if s < lim else self._stage_parked).append(s)

    @property
    def spill_capacity(self) -> int:
        """Demotion slots the engine owns (0 until ``enable_demotion``)."""
        return len(self._spill_slots)

    @property
    def spill_slots_free(self) -> int:
        """Demotion slots neither parking a block nor awaiting the drain
        of a queued resume."""
        return len(self._spill_free)

    @property
    def n_primary(self) -> int:
        """Number of primary pools (every plain command moves a block
        in each)."""
        return self.group.n_primary

    @property
    def primary_names(self) -> Tuple[str, ...]:
        """Names of the primary pools, in the group's order."""
        return self.group.primary_names

    def _pool_block_bytes(self, name: str) -> int:
        shape, dtype = self._pool_layouts[name]
        return int(np.prod(shape)) // shape[self.block_axis] * dtype.itemsize

    def _block_bytes(self) -> int:
        """Bytes one plain command moves (one block of every primary pool)."""
        return sum(self._pool_block_bytes(n) for n in self.primary_names)

    def pool_bytes_resident(self) -> int:
        """Total bytes resident across every pool (primary + staging)."""
        return sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in self._pool_layouts.values())

    def _pad(self, pairs: Sequence[Tuple[int, ...]], width: int = 2
             ) -> np.ndarray:
        """One fan-out call's ids, padded with ``-1`` rows to
        ``max_requests``."""
        arr = np.full((self.max_requests, width), -1, np.int32)
        if pairs:
            a = np.asarray(pairs, np.int32).reshape(-1, width)
            arr[:len(a)] = a[:self.max_requests]
        return arr

    def _get_zero_blocks(self) -> Tuple[torch.Tensor, ...]:
        """Per-pool reserved zero row for BuZ — allocated once."""
        if self._zero_blocks is None:
            self._zero_blocks = tuple(
                torch.zeros((1,) + shape[self.block_axis + 1:], dtype=dtype,
                            device=self.device)
                for shape, dtype in self._pool_layouts.values())
        return self._zero_blocks

    def mark_pools_written(self, names: Sequence[str]) -> None:
        """Record an out-of-band in-place write (e.g. the decode step's
        K/V append): tickets that describe these pools expire."""
        for n in names:
            self.pool_generation[n] += 1

    # ------------------------------------------------------------------
    # flush control
    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Drain the DEFAULT stream's queue.  Returns launches issued."""
        return self._default_stream.queue.flush()

    def _flush_streams(self) -> None:
        """Drain EVERY queue with pending commands."""
        for q in list(self._live_queues.values()):
            q.flush()

    def _autoflush(self) -> None:
        if not self.deferred:
            self._cur_queue.flush()

    @contextlib.contextmanager
    def batch(self) -> Iterator[CommandQueue]:
        """Defer flushing: commands enqueued inside the block drain as one
        fused launch at exit."""
        prev = self.deferred
        self.deferred = True
        try:
            yield self._cur_queue
        finally:
            self.deferred = prev
            if not self.deferred:
                self._cur_queue.flush()

    @property
    def next_flush_index(self) -> int:
        """Engine-wide index the NEXT drained flush will carry."""
        return self._flush_index

    def _drain_rows(self, rows: Sequence[Tuple[int, int, int]],
                    queue: Optional[CommandQueue] = None,
                    record: bool = True, pre_spaced: bool = False) -> int:
        """Space, chunk and dispatch one flush's rows; append the
        :class:`JournalRecord` on success.  The one drain path of
        ``CommandQueue.flush``, ``TicketJournal.replay`` (``record=False,
        pre_spaced=True``: records hold spaced rows) and ``recover()``'s
        re-drains of aborted suffixes (``pre_spaced=True``).

        Every chunk runs the drain guards (and the sanitizer's table check
        and snapshot) BEFORE its dispatch.  A guard, a sanitizer finding or
        a dispatch that raises (a wrapper refuses a killed pool before it
        launches) aborts the flush: the dispatched prefix is journaled as
        an ``aborted`` record and the undispatched suffix stashed for
        ``recover()``.  The ``"drain"`` span closes on either path."""
        rows = [(int(op), int(s), int(d)) for op, s, d in rows]
        idx = self._flush_index
        self._flush_index += 1
        residency_us = queue.pop_residency_us() if queue is not None else 0.0
        t_drain = obs_metrics.now()
        if pre_spaced or not self._flush_spacing():
            spaced = rows
        else:
            spaced = space_war_rows(rows, self.group.locate,
                                    self.group.primary,
                                    self.group.total_blocks)
            if queue is not None:
                queue.stats.spacer_rows += len(spaced) - len(rows)
        name = queue.name if queue is not None else "replay"
        launches = 0
        table_len = 0
        top = top_bucket()
        with span("drain", stream=name, flush=idx):
            for ci, lo in enumerate(range(0, len(spaced), top)):
                chunk = spaced[lo:lo + top]
                try:
                    check_drain(DrainInfo(
                        flush=idx, chunk=ci,
                        n_commands=sum(1 for r in chunk if r[0] >= 0),
                        n_pools=len(self.pools), engine=self))
                    table = np.full((bucket_size(len(chunk)), 3), OP_NOP,
                                    np.int32)
                    table[:len(chunk)] = np.asarray(chunk, np.int32)
                    table_len += len(table)
                    san = self.sanitizer
                    shadow_pre = None
                    if san is not None:
                        san.check_table(table, flush=idx, chunk=ci,
                                        spaced=self._flush_spacing())
                        shadow_pre = san.shadow_snapshot()
                    launches += self._dispatch_table(table, queue)
                    if shadow_pre is not None:
                        san.check_shadow(shadow_pre, table)
                except Exception:
                    if record:
                        done = spaced[:lo]
                        if any(op >= 0 for op, _, _ in done):
                            # the dispatched chunks moved bytes: journal
                            # them so replay reproduces the partial state
                            self.journal.append(JournalRecord(
                                stream=name, index=idx, rows=tuple(done),
                                launches=launches, aborted=True))
                        self._aborted.append(AbortedFlush(
                            queue=name, index=idx, rows=tuple(rows),
                            suffix=tuple(spaced[lo:])))
                    raise
        drain_us = (obs_metrics.now() - t_drain) * 1e6
        self.last_drain_timing = FlushTiming(
            queue_residency_us=residency_us, drain_us=drain_us,
            table_len=table_len, launches=launches)
        if obs_metrics.metrics_enabled():
            op_counts: Dict[int, int] = {}
            spacers = 0
            for op, _s, _d in spaced:
                if op < 0:
                    spacers += 1
                else:
                    op_counts[op] = op_counts.get(op, 0) + 1
            for op, cnt in op_counts.items():
                obs_metrics.inc("drain.rows", cnt, stream=name,
                                opcode=OPCODE_NAMES.get(op, str(op)))
            if spacers:
                obs_metrics.inc("drain.spacer_rows", spacers, stream=name)
            obs_metrics.inc("drain.launches", launches, stream=name)
            obs_metrics.observe("drain.flush_us", drain_us, stream=name)
            obs_metrics.observe("drain.table_len", table_len, stream=name)
        if record:
            self.journal.append(JournalRecord(
                stream=name, index=idx, rows=tuple(spaced),
                launches=launches,
                war_hazards=(queue.stats.war_hazards if queue else 0),
                spacer_rows=(queue.stats.spacer_rows if queue else 0)))
        return launches

    def _touched_pools(self, rows: Sequence[Tuple[int, int, int]]
                       ) -> Tuple[str, ...]:
        """Pool names a set of command rows WRITES."""
        hit = set()
        for op, s, d in rows:
            if op < 0:
                continue
            _, writes = row_rw(op, s, d, self.group.locate,
                               self.group.total_blocks)
            for p, _b in writes:
                if p == ALL_PRIMARY:
                    hit.update(self.primary_names)
                else:
                    hit.add(self.group.names[p])
        return tuple(n for n in self.group.names if n in hit)

    # ------------------------------------------------------------------
    # snapshot + recovery
    # ------------------------------------------------------------------
    def kill_pool(self, name: str) -> None:
        """Free pool ``name``'s storage in place, keeping its shape (the
        port's counterpart of the reference's donated-and-lost buffer,
        ``jax.Array.delete``): every block-moving wrapper then refuses the
        pool until :meth:`recover` resurrects it, and tickets that describe
        it expire.  A CPU pool that a numpy array shares (``Tensor.numpy()``)
        cannot be resized, and torch raises.  Under a mesh every slab of
        the pool dies."""
        for t in self.slabs(name):
            t.untyped_storage().resize_(0)
        self.mark_pools_written((name,))

    def snapshot(self) -> PoolSnapshot:
        """Host copies of EVERY pool (:func:`~repro_torch.core.journal
        .to_host`: bfloat16 as uint16 bits), consistent through the last
        drained flush (quiesce the streams first for an exact snapshot)."""
        return PoolSnapshot(
            index=self._flush_index - 1,
            arrays={n: to_host(p) for n, p in self.pools.items()})

    def _reads_lost(self, row: Tuple[int, int, int],
                    lost_idx: frozenset) -> bool:
        """Does a row read or write a pool that died without a snapshot?
        Such rows are unrecoverable: recover() drops them.  Plain opcodes
        key ``ALL_PRIMARY`` (-1), never a lost pool index."""
        if not lost_idx:
            return False
        op, s, d = row
        reads, writes = row_rw(op, s, d, self.group.locate,
                               self.group.total_blocks)
        return any(p in lost_idx for p, _b in reads + writes)

    def recover(self, snapshot: Optional[PoolSnapshot] = None,
                max_retries: int = 3, backoff: float = 0.05,
                degraded_stage_capacity: Optional[int] = None
                ) -> RecoveryReport:
        """Return the engine to a serviceable state after a failed flush
        or a killed pool, in five steps:

        1. **Evict**: every live stream's queued rows are dropped
           (``CommandQueue.abort``); promotions out of the staging pools
           are counted apart, for the serving layer to evict.
        2. **Restore**: killed pools come back from ``snapshot`` when it
           covers them, else as zeros (``pools_lost``).  Live pools are
           never touched.
        3. **Reset staging**: every slot returns to the free list;
           ``degraded_stage_capacity`` caps the ring (sticky: regrowing
           on demand stops there).
        4. **Replay**: when step 2 restored pools from the snapshot, the
           journal re-drains every record after ``snapshot.index``.
        5. **Re-drain**: aborted flushes' undispatched suffixes re-drain
           pre-spaced, up to ``max_retries`` attempts each with
           exponential backoff; exhaustion raises :class:`RecoveryError`.
           Rows touching pools lost without a snapshot drop."""
        aborted, self._aborted = list(self._aborted), []
        evicted = 0
        evicted_promotions = 0
        staging_idx = frozenset(self.group.index(n) for n in self.staging)
        for q in list(self._live_queues.values()):
            for op, s, d in q.abort():
                if op < 0:
                    continue
                evicted += 1
                if op == OP_CROSS_POOL_COPY and \
                        self.group.locate(int(s))[0] in staging_idx:
                    evicted_promotions += 1
        restored: List[str] = []
        lost: List[str] = []
        for name in list(self.pools):
            if not self.pool_is_dead(name):
                continue
            shape, dtype = self._pool_layouts[name]
            if snapshot is not None and name in snapshot.arrays:
                t = from_host(snapshot.arrays[name], dtype, self.device)
                if tuple(t.shape) != shape:
                    raise RecoveryError(
                        f"snapshot of pool {name!r} has shape "
                        f"{tuple(t.shape)}, the pool {shape}")
                restored.append(name)
            else:
                t = torch.zeros(shape, dtype=dtype, device=self.device)
                lost.append(name)
            self.pools[name] = t
            self.mark_pools_written((name,))
        # every reservation and queued promotion is void now; in-flight
        # resume promotions were aborted with the queues (the serving
        # layer re-promotes or releases their slots)
        self._stage_inflight = []
        self._spill_inflight = []
        cap = self.stage_capacity
        self._stage_free = list(range(cap - 1, -1, -1))
        self._stage_parked = []
        self._stage_limit = None
        if degraded_stage_capacity is not None:
            self._stage_degraded_cap = min(cap, int(degraded_stage_capacity))
            self.set_stage_limit(self._stage_degraded_cap)
        else:
            self._stage_degraded_cap = None
        replayed = 0
        if restored and snapshot is not None:
            replayed = self.journal.replay(self, after=snapshot.index)
        retries = 0
        lost_idx = frozenset(self.group.index(n) for n in lost)
        redrained = 0
        for ab in aborted:
            rows = [r for r in ab.suffix
                    if not self._reads_lost(r, lost_idx)]
            if not any(op >= 0 for op, _, _ in rows):
                continue
            for attempt in range(max_retries):
                try:
                    self._drain_rows(rows, record=True, pre_spaced=True)
                    redrained += 1
                    break
                except Exception as e:
                    self._aborted = []  # failed retries don't re-stash
                    retries += 1
                    if attempt == max_retries - 1:
                        raise RecoveryError(
                            f"re-drain of flush {ab.index} (stream "
                            f"{ab.queue!r}) still failing after "
                            f"{max_retries} attempts") from e
                    time.sleep(backoff * (2 ** attempt))
        return RecoveryReport(
            evicted_rows=evicted, evicted_promotions=evicted_promotions,
            pools_restored=tuple(restored), pools_lost=tuple(lost),
            replayed_flushes=replayed, redrained_flushes=redrained,
            retries=retries,
            degraded=degraded_stage_capacity is not None)

    def _flush_spacing(self) -> bool:
        """Should a flush WAR-space its global table?  Not when it drains
        through the sharded path: ``partition_commands`` spaces each
        rank's sub-table instead, and the plan's spacers are credited to
        the flushing queue (``_dispatch_sharded``)."""
        return not (self.use_fused and self._multi_device())

    def _dispatch_table(self, table: np.ndarray,
                        queue: Optional[CommandQueue] = None) -> int:
        """Execute one bucket-padded table, in place: ONE fused dispatch
        (under a mesh one sharded drain), or the fan-out with
        ``use_fused=False``.  Returns launches issued (0 for an all-NOP
        table).  ``queue`` (the flushing queue) is credited with the
        sharded plan's spacers."""
        live = [tuple(r) for r in table.tolist() if r[0] >= 0]
        if not live:
            return 0
        if not self.use_fused:
            return self._dispatch_legacy(live)
        if self._multi_device():
            replicated = self._pool_replicated()
            ragged = [sp.name for i, sp in enumerate(self.group)
                      if not replicated[i] and sp.nblk % self.n_shards]
            if ragged:
                # slabs would be ragged: degrade to the fan-out, loudly
                # (the caller loses the one-launch-per-flush invariant)
                if not self._warned_unshardable:
                    self._warned_unshardable = True
                    warnings.warn(
                        f"RowCloneEngine: pools {ragged} have block counts "
                        f"not divisible by {self.n_shards} device shards; "
                        "mesh flushes fall back to the multi-launch legacy "
                        "fan-out")
                return self._dispatch_legacy(live)
            if any(replicated) and self._writes_replicated(live, replicated):
                # a sharded -> replicated write needs a broadcast hop the
                # sharded drain does not model: the fan-out writes every
                # replica
                return self._dispatch_legacy(live)
            return self._dispatch_sharded(live, replicated, queue)
        kops.fused_dispatch(tuple(self.pools.values()),
                            self._get_zero_blocks(), table,
                            block_axis=self.block_axis,
                            primary=self.group.primary)
        self.mark_pools_written(self._touched_pools(live))
        self.stats.launches += 1
        return 1

    def _writes_replicated(self, rows, replicated: Tuple[bool, ...]
                           ) -> bool:
        """Does any global-dst row write a replicated pool from a SHARDED
        source?  (Replicated -> replicated writes drain in the sharded
        path: every rank applies them to its replica.)"""
        for op, s, d in rows:
            if op < 0 or opspec(op).dst_kind != "global":
                continue
            reads, writes = row_rw(op, s, d, self.group.locate,
                                   self.group.total_blocks)
            if replicated[writes[0][0]] and any(not replicated[p]
                                                for p, _b in reads):
                return True
        return False

    def _dispatch_sharded(self, rows, replicated: Tuple[bool, ...],
                          queue: Optional[CommandQueue] = None) -> int:
        """ONE sharded drain of the whole table: its ``ShardPlan``
        (slab-local sub-tables, each pool partitioned by its own slab
        size, replicated pools whole on every rank; cross-slab commands as
        K7 hops) checked by the sanitizer, then drained by K7 and K1 per
        rank (kernels/fused_dispatch.py ``sharded_fused_dispatch``)."""
        plan = partition_commands(rows, n_shards=self.n_shards,
                                  group=self.group, replicated=replicated)
        if self.sanitizer is not None:
            self.sanitizer.check_plan(rows, plan, replicated)
        self._last_plan_sig = (plan.n_shards, plan.deltas,
                               int(plan.send_rows.shape[2]))
        if queue is not None:
            queue.stats.spacer_rows += plan.n_spacers
        kops.fused_dispatch_sharded(
            [self._slabs[n] for n in self.group.names], plan, mesh=self.mesh,
            block_axis=self.block_axis, primary=self.group.primary,
            replicated=replicated)
        self.mark_pools_written(self._touched_pools(rows))
        self.stats.launches += 1
        return 1

    # ------------------------------------------------------------------
    # per-mechanism fan-out (use_fused=False)
    # ------------------------------------------------------------------
    def _dispatch_legacy(self, rows: Sequence[Tuple[int, int, int]]) -> int:
        """One call per mechanism per pool, padded to ``max_requests``
        (``repro/core/rowclone.py _dispatch_legacy``).  Rows batch per
        CONSECUTIVE run of one opcode, in enqueue order: the queue admits
        write-after-read pairs, which grouping the whole table would
        reorder.  Within a call sources see the pre-call state."""
        launches = 0
        for op, run in _runs(rows, lambda r: r[0]):
            run = [(s, d) for _, s, d in run]
            if op in (OP_FPM_COPY, OP_PSM_COPY, OP_BASELINE_COPY):
                launches += self._legacy_copy(op, run)
            elif op == OP_ZERO_INIT:
                launches += self._legacy_zero([d for _, d in run])
            elif op == OP_CROSS_POOL_COPY:
                launches += self._legacy_cross(run)
            elif op in BITWISE_OPS:
                launches += self._legacy_bitwise(op, run)
        self.stats.launches += launches
        return launches

    def _legacy_launch(self, mechanism: str, name: str) -> None:
        """Account one fan-out call that wrote pool ``name``."""
        notify_launch(self.max_requests, 1, mechanism)
        self.mark_pools_written((name,))

    def _legacy_copy(self, op: int, pairs: List[Tuple[int, int]]) -> int:
        """FPM (K5a), PSM (K7 with one rank and hop 0; under a mesh, the
        ranks and hops the pairs span) or baseline (float32 round-trip,
        no kernel) copies of one run, per chunk per primary pool."""
        ba = self.block_axis
        if self._multi_device():
            fn = functools.partial(self._mesh_copy, op)
            mech = {OP_FPM_COPY: "legacy_fpm", OP_PSM_COPY: "legacy_psm"}.get(
                op, "legacy_baseline")
        elif op == OP_FPM_COPY:
            mech, fn = "legacy_fpm", functools.partial(kops.fpm_copy,
                                                       block_axis=ba)
        elif op == OP_PSM_COPY:
            mech, fn = "legacy_psm", functools.partial(kops.psm_copy,
                                                       block_axis=ba)
        else:
            mech, fn = "legacy_baseline", functools.partial(
                kops.baseline_copy, block_axis=ba)
        launches = 0
        for chunk in _chunks(pairs, self.max_requests):
            ids = self._pad(chunk)
            for name in self.primary_names:
                if self._multi_device():
                    fn(name, ids)
                else:
                    fn(self.pools[name], ids)
                self._legacy_launch(mech, name)
                launches += 1
        return launches

    def _legacy_zero(self, ids_list: List[int]) -> int:
        """BuZ zero rows (K6), per chunk per primary pool."""
        launches = 0
        for chunk in _chunks(ids_list, self.max_requests):
            ids = self._pad(chunk, width=1)[:, 0]
            for name in self.primary_names:
                if self._multi_device():
                    self._mesh_zero(name, ids)
                else:
                    kops.meminit_zero(self.pools[name], ids,
                                      block_axis=self.block_axis)
                self._legacy_launch("legacy_zero", name)
                launches += 1
        return launches

    def _legacy_cross(self, gid_pairs: List[Tuple[int, int]]) -> int:
        """Cross-pool rows (K5b), split into runs of one (src pool, dst
        pool) pair in ENQUEUE order: interleaved opposite directions may
        carry a write-after-read."""
        names = list(self.pools)
        loc = [(self.group.locate(s), self.group.locate(d))
               for s, d in gid_pairs]
        launches = 0
        for (ps, pd), run in _runs(loc, lambda x: (x[0][0], x[1][0])):
            local = [(ls, ld) for (_, ls), (_, ld) in run]
            for chunk in _chunks(local, self.max_requests):
                if self._multi_device():
                    self._mesh_moves(names[ps], names[pd], self._pad(chunk))
                else:
                    kops.fpm_copy_cross(self.pools[names[pd]],
                                        self.pools[names[ps]],
                                        self._pad(chunk),
                                        block_axis=self.block_axis)
                self._legacy_launch("legacy_cross", names[pd])
                launches += 1
        return launches

    def _legacy_bitwise(self, op: int,
                        packed_pairs: List[Tuple[int, int]]) -> int:
        """AND/OR/NOT rows as plain tensor code, split into runs of one
        (a pool, b pool, dst pool) triple in enqueue order."""
        names = list(self.pools)
        total = self.group.total_blocks
        dec = []
        for s, d in packed_pairs:
            a, b = unpack_bitwise_src(s, total)
            dec.append((self.group.locate(a), self.group.locate(b),
                        self.group.locate(d)))
        launches = 0
        for (pa, pb, pd), run in _runs(
                dec, lambda x: (x[0][0], x[1][0], x[2][0])):
            local = [(la, lb, ld) for (_, la), (_, lb), (_, ld) in run]
            for chunk in _chunks(local, self.max_requests):
                if self._multi_device():
                    ids = self._pad(chunk, width=3)
                    ids = ids[ids[:, 2] >= 0]
                    srcs = [(pa, ids[:, 0])] + (
                        [] if op == OP_NOT else [(pb, ids[:, 1])])
                    self._mesh_plain(pd, ids[:, 2], srcs,
                                     functools.partial(_combine, op))
                else:
                    _bitwise(self.pools[names[pd]], self.pools[names[pa]],
                             self.pools[names[pb]], self._pad(chunk, width=3),
                             op, self.block_axis)
                self._legacy_launch("legacy_bitwise", names[pd])
                launches += 1
        return launches

    # -- the fan-out over a rank mesh ------------------------------------
    def _mesh_copy(self, op: int, name: str, ids: np.ndarray) -> None:
        """One fan-out call of a plain copy run on pool ``name`` under a
        mesh: FPM and PSM through :meth:`_mesh_moves` (PSM pairs all
        through K7), baseline as plain tensor code per rank
        (:meth:`_mesh_plain`, float32 round trip)."""
        if op == OP_BASELINE_COPY:
            p = self.group.index(name)
            ids = np.asarray(ids, np.int64).reshape(-1, 2)
            ids = ids[(ids[:, 1] >= 0) & (ids[:, 1] < self.group[p].nblk)]
            self._mesh_plain(p, ids[:, 1], [(p, ids[:, 0])],
                             lambda v, dtype: (v[0].float() * 1.0).to(dtype))
            return
        self._mesh_moves(name, name, ids, psm=op == OP_PSM_COPY)

    def _mesh_blocks(self, p: int, blks: np.ndarray, rank: int
                     ) -> torch.Tensor:
        """Blocks ``blks`` of pool ``p`` (pool ids, clipped into range) as
        a write on ``rank`` reads them: taken from the slabs that hold
        them, on ``rank``'s device, in order."""
        ba = self.block_axis
        slabs = self._slabs[self.group.names[p]]
        blks = np.clip(np.asarray(blks, np.int64), 0, self.group[p].nblk - 1)
        at = np.array([self._read_at(p, b, rank) for b in blks.tolist()],
                      np.int64).reshape(-1, 2)
        dev = self._shard_devices[rank]
        parts, order = [], []
        for rs in np.unique(at[:, 0]).tolist():
            sel = np.flatnonzero(at[:, 0] == rs)
            idx = torch.as_tensor(at[sel, 1], device=slabs[rs].device)
            parts.append(slabs[rs].index_select(ba, idx).to(dev))
            order.append(sel)
        inv = np.argsort(np.concatenate(order), kind="stable")
        return torch.cat(parts, ba).index_select(
            ba, torch.as_tensor(inv, device=dev))

    def _mesh_plain(self, pd: int, dsts: np.ndarray, srcs, combine
                    ) -> None:
        """Plain-code fan-out rows under a mesh, per rank: block
        ``dsts[i]`` of pool ``pd`` (every replica of a replicated pool)
        becomes ``combine([operand blocks], dtype)``, the operands
        ``srcs`` ``[(pool, ids)]`` read for that rank (:meth:`_mesh_blocks`)
        from the pre-call state before any rank writes."""
        ba = self.block_axis
        slabs = self._slabs[self.group.names[pd]]
        per: Dict[int, Tuple[List[int], List[int]]] = {}
        for i, d in enumerate(np.asarray(dsts, np.int64).tolist()):
            for r, ld in self._write_at(pd, d):
                rows, lds = per.setdefault(r, ([], []))
                rows.append(i)
                lds.append(ld)
        out = {r: (lds, combine([self._mesh_blocks(p, np.asarray(ids)[rows],
                                                    r) for p, ids in srcs],
                                slabs[r].dtype))
               for r, (rows, lds) in per.items()}
        for r, (lds, vals) in out.items():
            slabs[r].index_copy_(
                ba, torch.as_tensor(lds, device=slabs[r].device), vals)

    def _mesh_moves(self, src: str, dst: str, ids: np.ndarray,
                    psm: bool = False) -> None:
        """``dst[d] = src[s]`` for the ``(m, 2)`` pool-local ids (``-1``
        padding, sources clipped) over the ranks' slabs, sources read
        before the call writes, in waves (:func:`pair_waves`: a later
        pair may overwrite an earlier pair's source).  In each wave a
        block that stays on its rank moves by K5a (K5b between pools) on
        that rank, a block that changes rank by ONE K7 launch; ``psm``
        sends every pair through K7, hop 0 included.  A replicated
        destination is written on every rank, from the replica of a
        replicated source on that rank."""
        ps, pd = self.group.index(src), self.group.index(dst)
        live = _live_pairs(ids, self.group[ps].nblk, self.group[pd].nblk)
        if not len(live):
            return
        waves = pair_waves(live, same_pool=ps == pd)
        ba = self.block_axis
        for w in range(int(waves.max()) + 1):
            local: Dict[int, List[Tuple[int, int]]] = {}
            hops = []
            for s, d in live[waves == w].tolist():
                for rd, ld in self._write_at(pd, d):
                    rs, ls = self._read_at(ps, s, rd)
                    if rs == rd and not psm:
                        local.setdefault(rd, []).append((ls, ld))
                    else:
                        hops.append((0, rs, ls, ld, rd - rs))
            for r, prs in local.items():
                a = np.asarray(prs, np.int64)
                if ps == pd:
                    kops.fpm_copy(self._slabs[dst][r], a, block_axis=ba)
                else:
                    kops.fpm_copy_cross(self._slabs[dst][r],
                                        self._slabs[src][r], a,
                                        block_axis=ba)
            if hops:
                kops.psm_transfer_rows(
                    [(self._slabs[src], self._slabs[dst])],
                    np.asarray(hops, np.int64), block_axis=ba)

    def _mesh_zero(self, name: str, ids: np.ndarray) -> None:
        """BuZ rows of one fan-out call under a mesh: K6 on each rank that
        holds a listed block."""
        p = self.group.index(name)
        nblk = self.group[p].nblk
        per: Dict[int, List[int]] = {}
        for b in np.asarray(ids, np.int64).reshape(-1).tolist():
            if 0 <= b < nblk:
                for r, lb in self._write_at(p, b):
                    per.setdefault(r, []).append(lb)
        for r, lbs in per.items():
            kops.meminit_zero(self._slabs[name][r], np.asarray(lbs, np.int64),
                              block_axis=self.block_axis)

    # ------------------------------------------------------------------
    # memcopy
    # ------------------------------------------------------------------
    def _primary_id(self, b) -> int:
        """A primary-address-space operand: an int, or a BlockRef naming a
        primary pool."""
        if isinstance(b, BlockRef):
            if b.pool not in self.group.primary_names:
                raise ValueError(
                    f"plain copy/init addresses primary pools; "
                    f"{b.pool!r} is a staging pool (use memcopy_cross)")
            if not 0 <= int(b.block) < self.num_blocks:
                raise ValueError(f"block {b.block} out of range for "
                                 f"primary pools ({self.num_blocks})")
            return int(b.block)
        return int(b)

    def memcopy(self, pairs: Sequence[Tuple[object, object]],
                dst_is_fresh: bool = False) -> Dict[str, int]:
        """Copy block src -> dst in every primary pool, for each pair.
        Returns the count per mechanism.  ``dst_is_fresh`` (destinations
        never written, e.g. CoW targets) is accepted as the reference
        accepts it and changes nothing: the reference's ZI aliasing of
        fresh destinations lives in the CoW cache's fork."""
        counts = {"fpm": 0, "psm": 0, "baseline": 0}
        bb = self._block_bytes()
        aliased = 0
        for s, d in pairs:
            s, d = self._primary_id(s), self._primary_id(d)
            if self.enable_zi and self.alloc.is_zero[s]:
                # ZI in-cache copy: a lazily-zero source is a metadata move
                self.alloc.mark_zero([d])
                self.stats.alias_copies += 1
                self.stats.bytes_avoided += bb
                aliased += 1
                continue
            # mark now: a later pair of this call may read d as a source
            self.alloc.mark_written([d])
            if not self.enable_fpm:
                op = OP_BASELINE_COPY
            elif self.alloc.slab_of(s) == self.alloc.slab_of(d):
                op = OP_FPM_COPY
            elif self.enable_psm:
                op = OP_PSM_COPY
            else:
                op = OP_BASELINE_COPY
            if op == OP_FPM_COPY:
                counts["fpm"] += 1
                self.stats.fpm_copies += 1
                self.stats.bytes_fpm += bb
            elif op == OP_PSM_COPY:
                counts["psm"] += 1
                self.stats.psm_copies += 1
                self.stats.bytes_psm += bb
            else:
                counts["baseline"] += 1
                self.stats.baseline_copies += 1
                self.stats.bytes_baseline += bb
            self._cur_queue.enqueue(op, s, d)
        if obs_metrics.metrics_enabled():
            for mech, c in counts.items():
                if c:
                    obs_metrics.inc("engine.bytes_moved", c * bb,
                                    mechanism=mech)
            if aliased:
                obs_metrics.inc("engine.bytes_avoided", aliased * bb,
                                mechanism="alias")
        self._autoflush()
        return counts

    def memcopy_cross(self, pairs: Sequence[Tuple[object, object]]) -> int:
        """Pool-to-pool block copies: each ``(BlockRef, BlockRef)`` pair
        becomes one ``OP_CROSS_POOL_COPY`` row with global ids.  A lazily
        zero primary source is materialized first."""
        pairs = list(pairs)
        if not all(isinstance(s, BlockRef) and isinstance(d, BlockRef)
                   for s, d in pairs):
            raise TypeError("memcopy_cross pairs must be (BlockRef, BlockRef)")
        for s, d in pairs:
            self.group.gid(s), self.group.gid(d)
        lazy_srcs = [int(s.block) for s, _ in pairs
                     if s.pool in self.primary_names
                     and self.enable_zi and self.alloc.is_zero[s.block]]
        if lazy_srcs:
            self.materialize_zeros(lazy_srcs)
        for s, d in pairs:
            self._cur_queue.enqueue(OP_CROSS_POOL_COPY, self.group.gid(s),
                                    self.group.gid(d))
            self.stats.cross_pool_copies += 1
            self.stats.bytes_cross += self._pool_block_bytes(d.pool)
            obs_metrics.inc("engine.bytes_moved",
                            self._pool_block_bytes(d.pool),
                            mechanism="cross", pool=d.pool)
            if d.pool in self.primary_names:
                self.alloc.mark_written([int(d.block)])
        self._autoflush()
        return len(pairs)

    # ------------------------------------------------------------------
    # bitwise compute rows
    # ------------------------------------------------------------------
    def _bitwise_rows(self, triples, verb: str):
        """``(a, b, dst)`` triples — all BlockRefs, or all primary ints
        (fanned out to every primary pool) — as global-id rows; lazily
        zero primary sources materialize first."""
        rows = []
        lazy = set()
        for t in triples:
            a, b, d = t
            refs = [isinstance(x, BlockRef) for x in (a, b, d)]
            if any(refs):
                if not all(refs):
                    raise TypeError(f"{verb}: each triple must be all "
                                    f"BlockRefs or all ints, got {t!r}")
                for x in (a, b):
                    if x.pool in self.primary_names and self.enable_zi \
                            and self.alloc.is_zero[int(x.block)]:
                        lazy.add(int(x.block))
                rows.append((self.group.gid(a), self.group.gid(b),
                             self.group.gid(d), d))
            else:
                ai, bi, di = (self._primary_id(x) for x in (a, b, d))
                for x in (ai, bi):
                    if self.enable_zi and self.alloc.is_zero[x]:
                        lazy.add(x)
                for pname in self.primary_names:
                    base = self.group.base(pname)
                    rows.append((base + ai, base + bi, base + di,
                                 BlockRef(pname, di)))
        if lazy:
            self.materialize_zeros(sorted(lazy))
        return rows

    def _membitwise(self, op: int, rows) -> int:
        total = self.group.total_blocks
        check_pack_total(total)
        for a, b, d, dref in rows:
            self._cur_queue.enqueue(op, pack_bitwise_src(a, b, total), d)
            self.stats.bitwise_ops += 1
            self.stats.bytes_bitwise += self._pool_block_bytes(dref.pool)
            obs_metrics.inc("engine.bytes_moved",
                            self._pool_block_bytes(dref.pool),
                            mechanism="bitwise", pool=dref.pool)
            if dref.pool in self.primary_names:
                self.alloc.mark_written([int(dref.block)])
        self._autoflush()
        return len(rows)

    def memand(self, triples) -> int:
        """``dst = a & b`` on raw bits, per ``(a, b, dst)`` triple."""
        return self._membitwise(OP_AND, self._bitwise_rows(triples, "memand"))

    def memor(self, triples) -> int:
        """``dst = a | b`` on raw bits, per ``(a, b, dst)`` triple."""
        return self._membitwise(OP_OR, self._bitwise_rows(triples, "memor"))

    def memnot(self, pairs) -> int:
        """``dst = ~src`` on raw bits, per ``(src, dst)`` pair."""
        return self._membitwise(
            OP_NOT, self._bitwise_rows([(s, s, d) for s, d in pairs],
                                       "memnot"))

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------
    def stage_blocks(self, n: int) -> List[int]:
        """Reserve ``n`` staging slot ids; drains every stream first when
        the free list runs short (which reclaims drained promotions)."""
        if not self.staging:
            raise RuntimeError("engine has no staging pools")
        if len(self._stage_free) < n:
            self._flush_streams()
        if len(self._stage_free) < n:
            raise RuntimeError(
                f"staging pool exhausted ({n} slots requested, "
                f"{len(self._stage_free)} free of {self.stage_capacity})")
        return [self._stage_free.pop() for _ in range(n)]

    def release_stage_blocks(self, ids: Sequence[int]) -> None:
        """Return reserved staging slots that were never promoted."""
        self._reclaim_stage_slots([int(b) for b in ids])

    def promote_staged(self, pairs: Sequence[Tuple[int, object]]) -> int:
        """Promote staged pages ``(staging_slot, dst primary block)`` into
        primary blocks: one ``OP_CROSS_POOL_COPY`` per staging pool per
        block; the slots return to the ring once the promotion drained."""
        if not self.staging:
            raise RuntimeError("engine has no staging pools")
        pairs = [(int(s), self._primary_id(d)) for s, d in pairs]
        with self.batch():
            for sname, pname in self.staging.items():
                self.memcopy_cross([(BlockRef(sname, s), BlockRef(pname, d))
                                    for s, d in pairs])
            self.stats.stage_promotions += len(pairs)
            self._stage_inflight.extend(s for s, _ in pairs)
        return len(pairs)

    def retire_promotions(self, pairs: Sequence[Tuple[int, object]]) -> int:
        """Cancel queued promotions ``(staging_slot, dst)`` on every live
        queue and recycle their slots.  Returns rows retired."""
        if not self.staging:
            return 0
        pairs = [(int(s), self._primary_id(d)) for s, d in pairs]
        rows = [(OP_CROSS_POOL_COPY,
                 self.group.base(sname) + s, self.group.base(pname) + d)
                for sname, pname in self.staging.items()
                for s, d in pairs]
        removed = 0
        for q in list(self._live_queues.values()):
            removed += q.retire(rows)
        self.stats.retired_promotions += removed
        self._after_flush()
        return removed

    # ------------------------------------------------------------------
    # demotion: preemption parks primary blocks in spill slots (the
    # reverse of promotion), resumption promotes them back
    # ------------------------------------------------------------------
    def enable_demotion(self, slots: Sequence[int]) -> None:
        """Hand the engine spill-pool slot ids for preemption: they become
        the demotion slot space that :meth:`demote_to_spill` draws from."""
        if not self._spill_map:
            raise RuntimeError(
                "engine has no spill pools (PoolSpec(role='spill')); "
                "serving builds them via make_serving_pools")
        cap = min(self.group[n].nblk for n in self._spill_map.values())
        slots = [int(s) for s in slots]
        for s in slots:
            if not 0 <= s < cap:
                raise ValueError(f"spill slot {s} out of range ({cap})")
        self._spill_slots = tuple(slots)
        self._spill_free = list(reversed(slots))
        self._spill_inflight = []

    def demote_to_spill(self, blocks: Sequence[object]) -> List[int]:
        """Park primary blocks in spill slots: one ``OP_CROSS_POOL_COPY``
        per primary pool per block (k -> k_spill and v -> v_spill travel
        together) on the current queue.  Returns the slot of each block,
        in block order; the caller owns them until :meth:`promote_spilled`
        or :meth:`release_spill_slots`.  The copy reads the pools' bytes:
        blocks written out of band of the allocator's ZI metadata (the
        decode step's append) must be ``alloc.mark_written`` first."""
        if not self._spill_slots:
            raise RuntimeError("demotion not enabled (enable_demotion)")
        blocks = [self._primary_id(b) for b in blocks]
        if len(self._spill_free) < len(blocks):
            raise RuntimeError(
                f"spill slots exhausted ({len(blocks)} requested, "
                f"{len(self._spill_free)} free of {self.spill_capacity})")
        slots = [self._spill_free.pop() for _ in blocks]
        with self.batch():
            for pname, sname in self._spill_map.items():
                self.memcopy_cross(
                    [(BlockRef(pname, b), BlockRef(sname, s))
                     for b, s in zip(blocks, slots)])
            self.stats.demotions += len(blocks)
        return slots

    def promote_spilled(self, pairs: Sequence[Tuple[int, object]]) -> int:
        """Promote parked bytes ``(spill_slot, dst primary block)`` back
        into primary blocks (resumption); the slots return to the demotion
        free list once no stream holds a pending read of them."""
        if not self._spill_slots:
            raise RuntimeError("demotion not enabled (enable_demotion)")
        pairs = [(int(s), self._primary_id(d)) for s, d in pairs]
        with self.batch():
            for pname, sname in self._spill_map.items():
                self.memcopy_cross(
                    [(BlockRef(sname, s), BlockRef(pname, d))
                     for s, d in pairs])
            self.stats.spill_promotions += len(pairs)
            self._spill_inflight.extend(s for s, _ in pairs)
        return len(pairs)

    def release_spill_slots(self, ids: Sequence[int]) -> None:
        """Return demotion slots whose parked bytes are no longer needed,
        without promoting them.  Idempotent: free and in-flight slots are
        skipped."""
        for s in ids:
            s = int(s)
            if s not in self._spill_free and s not in self._spill_inflight:
                self._spill_free.append(s)

    def _after_flush(self) -> None:
        """A staging or in-flight demotion slot is reusable exactly when no
        stream still holds a pending read of it."""
        self._stage_inflight = self._reclaim_read(
            self._stage_inflight, self.staging, self._reclaim_stage_slots)
        self._spill_inflight = self._reclaim_read(
            self._spill_inflight, self._spill_map.values(),
            self._spill_free.extend)

    def _reclaim_read(self, inflight: List[int], names, reclaim
                      ) -> List[int]:
        """Hand the slots of ``inflight`` that no live queue still reads
        (in any pool of ``names``) to ``reclaim``; returns the rest."""
        if not inflight:
            return inflight
        idx = [self.group.index(n) for n in names]
        queues = list(self._live_queues.values())
        still: List[int] = []
        freed: List[int] = []
        for slot in inflight:
            if any(q.has_pending_read((p, slot)) for q in queues
                   for p in idx):
                still.append(slot)
            else:
                freed.append(slot)
        reclaim(freed)
        return still

    # ------------------------------------------------------------------
    # meminit
    # ------------------------------------------------------------------
    def meminit(self, ids: Sequence[object],
                lazy: Optional[bool] = None) -> int:
        """Zero blocks.  Returns the number physically zeroed (0 with ZI)."""
        ids = [self._primary_id(b) for b in ids]
        if lazy is None:
            lazy = self.enable_zi
        if lazy:
            self.alloc.mark_zero(ids)
            self.stats.zero_lazy += len(ids)
            self.stats.bytes_avoided += len(ids) * self._block_bytes()
            obs_metrics.inc("engine.bytes_avoided",
                            len(ids) * self._block_bytes(),
                            mechanism="zero_lazy")
            return 0
        self.materialize_zeros(ids)
        return len(ids)

    def materialize_zeros(self, ids: Sequence[object]) -> None:
        """BuZ through the reserved zero row."""
        ids = [self._primary_id(b) for b in ids]
        if not ids:
            return
        self.stats.zero_materialized += len(ids)
        self._cur_queue.enqueue_zero(ids)
        self.alloc.mark_written(ids)
        self._autoflush()


class MeshPools(collections.abc.MutableMapping):
    """``engine.pools`` of an engine over a rank mesh: pool name -> the
    WHOLE pool.  Reading a pool gathers its slabs into a new tensor on the
    engine's device (a replicated pool: a copy of rank 0's replica);
    writes to that tensor do not reach the slabs.  Assigning a whole pool
    writes it into the slabs (in place while they are alive, fresh after a
    kill).  The slabs themselves are ``engine.slabs(name)``."""

    def __init__(self, engine: "RowCloneEngine"):
        self._engine = weakref.proxy(engine)

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._engine.group.names:
            raise KeyError(name)
        return self._engine._gather(name)

    def __setitem__(self, name: str, t: torch.Tensor) -> None:
        if name not in self._engine.group.names:
            raise KeyError(name)
        self._engine._scatter(name, t)

    def __delitem__(self, name: str) -> None:
        raise TypeError("an engine's pools cannot be removed")

    def __iter__(self):
        return iter(self._engine.group.names)

    def __len__(self) -> int:
        return len(self._engine.group)


def _chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _runs(seq, key):
    """``(key, items)`` for each maximal run of consecutive items sharing
    ``key(item)``, in order."""
    for k, group in itertools.groupby(seq, key):
        yield k, list(group)


def _combine(op: int, vals: Sequence[torch.Tensor], dtype: torch.dtype
             ) -> torch.Tensor:
    """The raw-bit AND / OR of two block stacks, or NOT of one, as
    ``dtype``."""
    a = kref.int_view(vals[0])
    r = a & kref.int_view(vals[1]) if op == OP_AND else (
        a | kref.int_view(vals[1]) if op == OP_OR else ~a)
    return r.view(dtype)


def _bitwise(dst_pool: torch.Tensor, a_pool: torch.Tensor,
             b_pool: torch.Tensor, ids: np.ndarray, op: int,
             block_axis: int) -> None:
    """Fan-out bitwise combine, in place (``_bitwise_jit``): gather both
    sources from the pre-call state, combine their raw bits, scatter to
    ``dst``; ``ids`` (m, 3) ``[a, b, dst]`` local rows, ``-1`` skips."""
    ba = block_axis
    t = torch.from_numpy(ids.astype(np.int64)).to(dst_pool.device)
    keep = t[:, 2] >= 0
    t = t[keep]

    def gather(pool, idx):
        return pool.index_select(ba, idx.clamp(0, pool.shape[ba] - 1))

    vals = [gather(a_pool, t[:, 0])] + (
        [] if op == OP_NOT else [gather(b_pool, t[:, 1])])
    dst_pool.index_copy_(ba, t[:, 2], _combine(op, vals, dst_pool.dtype))


__all__ = ["EngineStats", "RowCloneEngine", "MeshPools"]
