"""K1 — the fused command-table drain: launch accounting, drain guards, the
wave schedule, the Python statement of the kernel's plan, and the CUDA
wrapper.

Replaces the TPU kernel ``_make_kernel`` of
``repro/kernels/fused_dispatch.py`` (``fused_dispatch_pallas``, the
``pallas_call`` at :406).  The kernel is ``csrc/fused_dispatch.cu`` over the
device pieces of ``csrc/block_move.cuh``; its plain version is
:func:`repro_torch.kernels.ref.fused_dispatch`.

Bound on the card: bytes (each row reads and writes one page per layer of
every pool it touches; bound = bytes / 3.35 TB/s).  The kernel streams raw
bytes with bulk asynchronous copies whatever the dtype.  Rows run
concurrently on the GPU, so each row gets a wave: :func:`wave_schedule`
puts every write-after-read writer in a later wave than every earlier
reader of its block, and a later wave's stores wait until the earlier
waves' items have been read, all inside ONE launch.  A table with a RAW or
WAW pair breaks the contract (the command queue never flushes one) and
raises here rather than drain differently from the plain version.

The wrapper makes ONE C call per drain: the library decodes the raw table,
expands each row into moves (a plain row into one per primary pool),
assigns the waves, sorts the moves and launches with them as launch
parameters (up to :data:`MOVE_CAPACITY` moves; above, through a device
buffer kept per stream), without numpy work or a blocking upload.
:func:`plan_moves` and :func:`chunking` state that plan in Python; the CPU
tests pin them, and ``chip_smoke.py`` holds the library's plan
(``rc_fused_plan``) against them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opcodes import (OP_AND, OP_CROSS_POOL_COPY, OP_NOT,
                                      OP_OR, OP_ZERO_INIT, keys_clash,
                                      row_rw)
from repro_torch.kernels import fpm_copy
from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.fpm_copy import (OUT_WORDS, RAW, WAW,
                                          block_geometry, id_array,
                                          sm_count, stream_counters)
from repro_torch.kernels.ref import address_space, as_primary

#: launches of the CUDA drain kernel (not of its plain version)
COUNTER = LaunchCounter("fused_dispatch")

# ---------------------------------------------------------------------------
# dispatch accounting — every bulk-movement dispatch (kernel or plain
# version) reports here, so tests can assert launches per flush on any device
# ---------------------------------------------------------------------------

_LAUNCH_HOOKS: List[Callable[[int, int, str], None]] = []
_LAUNCH_COUNT = 0


def add_launch_hook(fn: Callable[[int, int, str], None]) -> None:
    """Register ``fn(n_commands, n_pools, mechanism)`` to fire per dispatch."""
    _LAUNCH_HOOKS.append(fn)


def remove_launch_hook(fn: Callable[[int, int, str], None]) -> None:
    """Unregister a hook added with :func:`add_launch_hook`."""
    _LAUNCH_HOOKS.remove(fn)


def launch_count() -> int:
    """Cumulative bulk-movement dispatches this process."""
    return _LAUNCH_COUNT


def notify_launch(n_commands: int, n_pools: int, mechanism: str) -> None:
    """Record one bulk-movement dispatch."""
    global _LAUNCH_COUNT
    _LAUNCH_COUNT += 1
    for fn in _LAUNCH_HOOKS:
        fn(n_commands, n_pools, mechanism)


# ---------------------------------------------------------------------------
# drain guards — run before every chunk's dispatch; a guard that raises
# aborts the flush before the pools are touched
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DrainInfo:
    """One chunk of a flush, about to dispatch."""

    flush: int        #: engine-wide flush index
    chunk: int        #: overflow-chunk ordinal within the flush (0-based)
    n_commands: int   #: live (non-NOP) rows in this chunk
    n_pools: int      #: pools the dispatch will move
    engine: object = dataclasses.field(default=None, repr=False)


_DRAIN_GUARDS: List[Callable[[DrainInfo], None]] = []


def add_drain_guard(fn: Callable[[DrainInfo], None]) -> None:
    """Register ``fn(DrainInfo)`` to run before every chunk dispatch."""
    _DRAIN_GUARDS.append(fn)


def remove_drain_guard(fn: Callable[[DrainInfo], None]) -> None:
    """Unregister a guard added with :func:`add_drain_guard`."""
    _DRAIN_GUARDS.remove(fn)


def check_drain(info: DrainInfo) -> None:
    """Run every registered drain guard against one pending chunk."""
    for fn in list(_DRAIN_GUARDS):
        fn(info)


# ---------------------------------------------------------------------------
# host wave schedule
# ---------------------------------------------------------------------------

def wave_schedule(rows: Sequence[Tuple[int, int, int]],
                  sizes: Sequence[int],
                  primary: Sequence[bool]) -> List[int]:
    """The wave of each live row: 0, or 1 + the largest wave of any EARLIER
    row that reads a ``(pool, block)`` this row writes.  Running the waves
    in order, with the rows of one wave in any order, then equals the
    gather-then-scatter drain.  Raises ``ValueError`` on a RAW or WAW pair
    (the command queue's guards never flush one)."""
    _, total, locate = address_space(sizes)
    primary = tuple(primary)

    readers: Dict[int, List[Tuple[int, int]]] = {}   # block -> (pool, wave)
    written: Dict[int, List[int]] = {}               # block -> pools
    waves = []
    for op, s, d in rows:
        reads, writes = row_rw(op, s, d, locate, total)
        for key in reads:
            if any(keys_clash(key, (p, key[1]), primary)
                   for p in written.get(key[1], ())):
                raise ValueError(f"row {(op, s, d)} reads a block an "
                                 "earlier row of the table writes (RAW)")
        wave = 0
        for key in writes:
            if any(keys_clash(key, (p, key[1]), primary)
                   for p in written.get(key[1], ())):
                raise ValueError(f"row {(op, s, d)} rewrites a block an "
                                 "earlier row of the table writes (WAW)")
            for p, w in readers.get(key[1], ()):
                if keys_clash(key, (p, key[1]), primary):
                    wave = max(wave, w + 1)
        waves.append(wave)
        for key in reads:
            if key not in writes:
                readers.setdefault(key[1], []).append((key[0], wave))
        for key in writes:
            written.setdefault(key[1], []).append(key[0])
    return waves


# ---------------------------------------------------------------------------
# the kernel's plan, in Python
# ---------------------------------------------------------------------------

# design constants of csrc/fused_dispatch.cu (``chip_smoke.py`` checks them
# against the library's ``rc_fused_constants``; the ring, chunk and grid
# limits are csrc/block_move.cuh's, imported above)
#: moves the launch parameters carry (the parameters stay under 4 KB);
#: above it the moves go through a device buffer
MOVE_CAPACITY = 188
#: pools one drain takes
MAX_POOLS = 16
#: chunk slots of a CTA's ring (an AND / OR move takes two)
STAGES = 4
#: threads of a CTA
THREADS = 128
#: bytes of one move in the launch parameters
MOVE_BYTES = 20
#: the library's codes for a row the contract does not know (an opcode, or
#: an id outside its space) and for too many pools
BAD_ROW, TOO_MANY_POOLS = -4, -5

#: kinds of move: a copy, zero bytes, AND / OR of two sources, NOT of one
COPY, ZERO, AND, OR, NOT = range(5)
_BITWISE = {OP_AND: AND, OP_OR: OR, OP_NOT: NOT}


def plan_moves(rows, sizes: Sequence[int], primary: Sequence[bool]
               ) -> Tuple[np.ndarray, List[int]]:
    """The moves the kernel gets for a table, and the wave of each live
    row (:func:`wave_schedule`, which raises on a RAW or WAW pair).

    NOP rows (``op < 0`` or ``dst < 0``) drop.  A plain row (ops 0-3)
    becomes one move per primary pool, in pool order; a cross-pool or
    bitwise row one move between the ``(pool, block)`` its global ids name
    (NOT reads its first source only).  Returns ``(n, 8)`` int32 rows
    ``[kind, pd, dst, pa, a, pb, b, first]`` (unused pool and block -1),
    sorted by wave (stable), ``first`` the index of the first move of the
    move's wave: its stores wait until every item before that move has been
    read."""
    live = [(int(op), int(s), int(d)) for op, s, d in
            np.asarray(rows, np.int64).reshape(-1, 3).tolist()
            if op >= 0 and d >= 0]
    waves = wave_schedule(live, sizes, primary)
    _, total, locate = address_space(sizes)
    moves, of_wave = [], []
    for (op, s, d), w in zip(live, waves):
        if op == OP_CROSS_POOL_COPY:
            (ps, ls), (pd, ld) = locate(s), locate(d)
            new = [(COPY, pd, ld, ps, ls, -1, -1)]
        elif op in _BITWISE:
            a, b = divmod(s, total)
            (pa, la), (pb, lb), (pd, ld) = locate(a), locate(b), locate(d)
            new = [(NOT, pd, ld, pa, la, -1, -1) if op == OP_NOT else
                   (_BITWISE[op], pd, ld, pa, la, pb, lb)]
        else:
            new = [(ZERO, p, d, -1, -1, -1, -1) if op == OP_ZERO_INIT else
                   (COPY, p, d, p, s, -1, -1)
                   for p in range(len(sizes)) if primary[p]]
        moves += new
        of_wave += [w] * len(new)
    out = np.empty((len(moves), 8), np.int32)
    if moves:
        order = np.argsort(of_wave, kind="stable")
        w = np.asarray(of_wave)[order]
        out[:, :7] = np.asarray(moves)[order]
        out[:, 7] = np.searchsorted(w, w, side="left")
    return out, waves


def chunking(n_moves: int, layers: int, page_bytes: int, *, bulk: bool,
             sms: int):
    """(chunk bytes, chunks per page, work items, grid) of a drain of
    ``n_moves`` moves: K5's rule (:func:`fpm_copy.chunking`) with a CTA
    holding :data:`STAGES` ring slots and the zero tile (one CTA per SM at
    32 KiB chunks)."""
    return fpm_copy.chunking(n_moves, layers, page_bytes, bulk=bulk,
                             zero=False, sms=sms, buffers=STAGES + 1)


_SIGNATURE = {
    "rc_fused_drain": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p],
    "rc_fused_plan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    """A C entry of ``csrc/fused_dispatch.cu``, its argument types set once
    when the library loads."""
    fn = getattr(library("fused_dispatch"), entry)
    fn.argtypes = _SIGNATURE[entry]
    fn.restype = ctypes.c_int
    return fn


def constants() -> dict:
    """The design constants as this module states them (the chunk and
    grid limits are K5's, csrc/block_move.cuh)."""
    fc = fpm_copy
    return dict(MOVE_CAPACITY=MOVE_CAPACITY, MAX_POOLS=MAX_POOLS,
                STAGES=STAGES, MIN_CHUNK=fc.MIN_CHUNK,
                MAX_CHUNK=fc.MAX_CHUNK, ITEMS_PER_SM=fc.ITEMS_PER_SM,
                MAX_CTAS_PER_SM=fc.MAX_CTAS_PER_SM,
                SMEM_PER_SM=fc.SMEM_PER_SM, THREADS=THREADS,
                MOVE_BYTES=MOVE_BYTES)


def library_constants() -> dict:
    """The design constants as the library has them, and the launch
    parameters' size (needs the card)."""
    fn = library("fused_dispatch").rc_fused_constants
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    out = np.zeros(11, np.int64)
    fn(out.ctypes.data)
    names = ("MOVE_CAPACITY", "MAX_POOLS", "STAGES", "MIN_CHUNK",
             "MAX_CHUNK", "ITEMS_PER_SM", "MAX_CTAS_PER_SM", "SMEM_PER_SM",
             "THREADS", "param_bytes", "MOVE_BYTES")
    return dict(zip(names, out.tolist()))


def _records(sizes: Sequence[int], primary: Sequence[bool],
             ptrs: Sequence[int]) -> np.ndarray:
    """The ``(n_pools, 3)`` int64 pool records the library reads: base
    address, blocks, primary."""
    return np.array([(p, n, r) for p, n, r in zip(ptrs, sizes, primary)],
                    np.int64).reshape(-1, 3)


def plan(cmds, sizes: Sequence[int], primary: Sequence[bool], *,
         layers: int, page_bytes: int, bulk: bool, sms: int,
         max_grid: int = 0):
    """The library's plan of one drain without a launch (needs the card's
    build): ``(code, moves, out)``, ``moves`` as :func:`plan_moves` gives
    them, ``out`` the :data:`OUT_WORDS` words (live rows, moves, work
    items, grid, chunk bytes, waves, bulk path, refused row)."""
    table = id_array(cmds, 3)
    recs = _records(sizes, primary, [0] * len(sizes))
    cap = max(1, len(table) * max(1, sum(map(bool, primary))))
    moves = np.zeros((cap, 8), np.int32)
    out = np.zeros(OUT_WORDS, np.int64)
    code = _entry("rc_fused_plan")(table.ctypes.data, table.itemsize,
                                   len(table), recs.ctypes.data, len(recs),
                                   layers, page_bytes, int(bulk), sms,
                                   max_grid, moves.ctypes.data, cap,
                                   out.ctypes.data)
    return code, moves[:int(out[1])], out


def refusal(code: int, table: np.ndarray, row: int, sizes: Sequence[int]
            ) -> ValueError:
    """The error of a table the library refused, as :func:`wave_schedule`
    and :func:`repro_torch.core.opcodes.row_rw` word it."""
    op, s, d = (int(x) for x in table[row])
    if code == RAW:
        return ValueError(f"row {(op, s, d)} reads a block an earlier row "
                          "of the table writes (RAW)")
    if code == WAW:
        return ValueError(f"row {(op, s, d)} rewrites a block an earlier "
                          "row of the table writes (WAW)")
    _, total, locate = address_space(sizes)
    try:
        row_rw(op, s, d, locate, total)
    except ValueError as e:
        return e
    return ValueError(f"row {(op, s, d)} names a block outside the primary "
                      "pools")


#: the device buffer of each (device, stream) for moves above the launch
#: parameters' room, grown when a table needs more
_MOVE_BUFFERS: Dict[Tuple[int, int], torch.Tensor] = {}
#: the ``out`` words of the last drain (read by ``chip_smoke.py``)
last_out = np.zeros(OUT_WORDS, np.int64)
_LAST_OUT_PTR = last_out.ctypes.data


def _move_buffer(device: torch.device, stream: int, moves: int
                 ) -> Tuple[int, int]:
    """(address, capacity in moves) of the stream's move buffer, room for
    at least ``moves``.  A buffer is only ever read by drains on its own
    stream, after the copy that fills it."""
    key = (device.index, stream)
    buf = _MOVE_BUFFERS.get(key)
    if buf is None or buf.numel() < moves * MOVE_BYTES:
        buf = _MOVE_BUFFERS[key] = torch.empty(
            max(moves, 512) * MOVE_BYTES, dtype=torch.uint8, device=device)
    return buf.data_ptr(), buf.numel() // MOVE_BYTES


def fused_dispatch_cuda(pools: Sequence[torch.Tensor], cmds, *,
                        block_axis: int,
                        primary: Optional[Sequence[bool]] = None,
                        max_grid: int = 0) -> Tuple[torch.Tensor, ...]:
    """Drain one command table over CUDA pools, in place, with ONE C call
    and ONE launch of the kernel (none for a table without moves), on the
    current stream.  Zero-init rows store zero bytes: the reserved zero
    block is all zeros by construction.  ``max_grid`` > 0 caps the grid
    (the checks run every kind of move through one CTA).  Raises
    ``ValueError`` on a table :func:`wave_schedule` refuses, with its
    message, and ``RuntimeError`` when the launch is refused."""
    pools = tuple(pools)
    primary = as_primary(primary, len(pools))
    layers, page_bytes, _ = block_geometry(pools, block_axis)
    table = id_array(cmds, 3)
    device = pools[0].device
    stream = stream_ptr(device)
    sizes = [int(p.shape[block_axis]) for p in pools]
    recs = _records(sizes, primary, [p.data_ptr() for p in pools])
    most = len(table) * max(1, sum(primary))
    buf, cap = (_move_buffer(device, stream, most) if most > MOVE_CAPACITY
                else (None, 0))
    err = _entry("rc_fused_drain")(
        table.ctypes.data, table.itemsize, len(table), recs.ctypes.data,
        len(pools), layers, page_bytes, stream_counters(device, stream),
        buf, cap, sm_count(device), max_grid, stream, _LAST_OUT_PTR)
    if err in (RAW, WAW, BAD_ROW):
        raise refusal(err, table, int(last_out[7]), sizes)
    if err == TOO_MANY_POOLS:
        raise ValueError(f"the fused drain takes at most {MAX_POOLS} pools, "
                         f"not {len(pools)}")
    check(err, "fused drain kernel")
    if last_out[1]:
        COUNTER.n += 1
    return pools


# ---------------------------------------------------------------------------
# the sharded drain over a rank mesh
# ---------------------------------------------------------------------------

def landing_plan(plan, primary: Sequence[bool], kinds: Sequence[int]):
    """How a plan's transfers travel and land, on the host: ``(hops,
    phase0, phase1, n_recv)``.

    ``kinds[p]`` names pool ``p``'s receive buffer (:func:`block_kinds`):
    pools of one block shape and dtype share one, so that a block lands
    bit for bit whatever its pool.  ``hops`` (k, 5) int64
    are K7's rows ``[pool, sender, send_row, slot, delta]``: block
    ``send_row`` of pool ``pool`` on the sender goes to block ``slot`` of
    its kind's receive buffer on rank ``(sender + delta) % S``.  A
    whole-block entry (a plain opcode) sends its block of every primary
    pool; a cross-pool or bitwise entry the block of the pool it names.
    ``phase0[r]`` / ``phase1[r]`` are rank ``r``'s landing rows in the
    address space of its slabs followed by its receive buffers in kind
    order (global id ``lt + base[kind] + slot``, ``lt`` the plan's
    slab-local total): phase 0 a cross-pool copy (or ``OP_NOT``) of the
    slot into the destination, phase 1 ``OP_AND`` / ``OP_OR`` of the
    landed destination with the slot (two-source bitwise rows packed
    against the whole address space).  ``n_recv[kind]`` is the largest
    slot count of any rank for that kind (0: no buffer)."""
    S = plan.n_shards
    n_kinds = max(kinds) + 1
    bases = np.concatenate([[0], np.cumsum(plan.shard_sizes)[:-1]])
    lt = int(sum(plan.shard_sizes))
    prim = [p for p, is_p in enumerate(primary) if is_p]
    hops, landing = [], []
    slots = np.zeros((S, n_kinds), np.int64)
    # the live entries, in (delta, receiver, slot) order
    for k, sh_d, j in zip(*np.nonzero(plan.recv_tables[..., 2] >= 0)):
        delta = plan.deltas[k]
        sh_s = (int(sh_d) - delta) % S
        bp, dp, dr, comb = (int(x) for x in plan.recv_tables[k, sh_d, j])
        row = int(plan.send_rows[k, sh_s, j])
        for q, pd in ([(bp, dp)] if bp >= 0 else [(p, p) for p in prim]):
            g = kinds[q]
            c = int(slots[sh_d, g])
            slots[sh_d, g] += 1
            hops.append((q, sh_s, row, c, delta))
            landing.append((int(sh_d), g, c, int(bases[pd]) + dr, comb))
    n_recv = slots.max(0).tolist()
    rbase = np.concatenate([[0], np.cumsum(n_recv)[:-1]]) + lt
    total = lt + int(sum(n_recv))
    phase0 = [[] for _ in range(S)]
    phase1 = [[] for _ in range(S)]
    for sh_d, g, c, dst, comb in landing:
        src = int(rbase[g]) + c
        if comb in (OP_AND, OP_OR):
            phase1[sh_d].append((comb, dst * total + src, dst))
        elif comb == OP_NOT:
            phase0[sh_d].append((OP_NOT, src * total + src, dst))
        else:
            phase0[sh_d].append((OP_CROSS_POOL_COPY, src, dst))
    return (np.asarray(hops, np.int64).reshape(-1, 5), phase0, phase1,
            n_recv)


def _with_blocks(shape, block_axis: int, n: int) -> List[int]:
    out = list(shape)
    out[block_axis] = n
    return out


def block_kinds(pools: Sequence[torch.Tensor], block_axis: int
                ) -> List[int]:
    """Per pool, the index of its (block shape, dtype) among the pools'
    distinct ones, in first-seen order."""
    seen: Dict[Tuple, int] = {}
    return [seen.setdefault((tuple(t.shape[block_axis + 1:]),
                             t.shape[0] if block_axis else 1, t.dtype),
                            len(seen)) for t in pools]


def _repack(table: np.ndarray, lt: int, total: int) -> np.ndarray:
    """A slab-local sub-table with its two-source rows re-packed from the
    slab total ``lt`` to ``total`` (the receive buffers join the address
    space after every slab, so no other id moves)."""
    t = np.array(table, np.int64)
    bit = np.isin(t[:, 0], (OP_AND, OP_OR, OP_NOT))
    a, b = np.divmod(t[bit, 1], lt)
    t[bit, 1] = a * total + b
    return t


def sharded_fused_dispatch(slabs: Sequence[Sequence[torch.Tensor]], plan, *,
                           mesh, block_axis: int = 0,
                           primary: Optional[Sequence[bool]] = None,
                           replicated: Optional[Sequence[bool]] = None,
                           use_kernel: bool = False) -> None:
    """Drain one partitioned flush (a cmdqueue ``ShardPlan``) over the
    ranks' slabs, in place: ``slabs[p][r]`` is pool ``p``'s slab on rank
    ``r`` (a replicated pool's whole replica), ``use_kernel`` picks K7 and
    K1 (CUDA slabs) or their plain versions.  The reference's order:

    1. every transfer source is read from the PRE-drain slabs: K7 pushes
       them all into per-rank receive buffers (the hop), one buffer and
       ONE launch per (block shape, dtype) among the travelling pools, so
       every block lands bit for bit;
    2. each rank drains its slab-local sub-table with K1, with the
       phase-0 landing rows (overwrites, ``OP_NOT`` inverting) appended:
       the receive buffers are more (non-primary) pools of the drain, and
       K1's waves order a landing after every earlier read of its block;
    3. ranks with ``OP_AND`` / ``OP_OR`` combines drain them in a second
       K1 launch over the landed blocks (phase 1).

    Device launches per flush: K7 once per block kind that travels (once
    when the pools share one block shape and dtype), K1 once per
    rank with rows, and once more per rank with combines.  Reports ONE
    ``fused_mesh`` dispatch (:func:`notify_launch`), as the reference's
    one collective launch does."""
    from repro_torch.kernels import psm_transfer as k7
    from repro_torch.kernels import ref
    n_pools = len(slabs)
    S = plan.n_shards
    primary = as_primary(primary, n_pools)
    replicated = tuple(replicated) if replicated is not None \
        else (False,) * n_pools
    kinds = block_kinds([slabs[p][0] for p in range(n_pools)], block_axis)
    hops, phase0, phase1, n_recv = landing_plan(plan, primary, kinds)
    lt = int(sum(plan.shard_sizes))
    # per kind with travelling blocks, one receive buffer on each rank,
    # shaped and typed like that kind's slabs
    recv = {}
    for g, n in enumerate(n_recv):
        if n:
            like = [slabs[kinds.index(g)][r] for r in range(S)]
            recv[g] = [torch.empty(_with_blocks(t.shape, block_axis, n),
                                   dtype=t.dtype, device=t.device)
                       for t in like]
    for g in recv:
        qs = [q for q in range(n_pools) if kinds[q] == g]
        rows = hops[np.isin(hops[:, 0], qs)]
        rows[:, 0] = np.searchsorted(qs, rows[:, 0])
        tables = [(list(slabs[q]), recv[g]) for q in qs]
        if use_kernel:
            k7.psm_transfer_cuda(tables, rows, block_axis=block_axis)
        else:
            ref.psm_transfer(tables, k7.check_rows(tables, rows, block_axis),
                             block_axis=block_axis)
    roles = primary + (False,) * len(recv)
    total = lt + int(sum(n_recv))
    for phase in (0, 1):
        for r in range(S):
            extra = (phase0 if phase == 0 else phase1)[r]
            if phase:
                base = np.zeros((0, 3), np.int64)
            elif recv:
                base = _repack(plan.local_tables[r], lt, total)
            else:
                base = np.asarray(plan.local_tables[r], np.int64)
            if extra:
                base = np.concatenate([base, np.asarray(extra, np.int64)])
            if not (base[:, 0] >= 0).any():
                continue
            pools = [slabs[p][r] for p in range(n_pools)] + \
                [recv[g][r] for g in sorted(recv)]
            if use_kernel:
                fused_dispatch_cuda(pools, base, block_axis=block_axis,
                                    primary=roles)
            else:
                zeros = [torch.zeros((1,) + tuple(t.shape[block_axis + 1:]),
                                     dtype=t.dtype, device=t.device)
                         for t in pools]
                ref.fused_dispatch(pools, zeros, base,
                                   block_axis=block_axis, primary=roles)
    notify_launch(int(plan.local_tables.shape[1]), n_pools, "fused_mesh")


__all__ = ["COUNTER", "DrainInfo", "add_drain_guard", "remove_drain_guard",
           "check_drain", "add_launch_hook", "remove_launch_hook",
           "launch_count", "notify_launch", "wave_schedule", "plan_moves",
           "chunking", "constants", "library_constants", "plan", "refusal",
           "fused_dispatch_cuda", "MOVE_CAPACITY", "MAX_POOLS",
           "landing_plan", "sharded_fused_dispatch"]
