"""K7 — the PSM transfer: block pushes between the slabs of a rank mesh,
the host contract, the plan and the CUDA wrapper.

Replaces the TPU kernel ``_psm_kernel`` of ``repro/kernels/psm_transfer.py``
(``psm_transfer_pallas``, the ``pallas_call`` at :74), which pushed
slab-local blocks into the slab of the device at a signed hop along one
mesh axis with remote DMAs, ``PIPELINE_DEPTH`` of them in flight.  The
kernel is ``csrc/psm_transfer.cu`` over the bulk-copy pieces and the word
loop of ``csrc/block_move.cuh``; its plain version is
:func:`repro_torch.kernels.ref.psm_transfer`.

The contract, kept from the reference: a row ``[src_local, dst_local,
hop]`` of rank ``my`` copies block ``src_local`` of ``my``'s slab into
block ``dst_local`` of the slab of rank ``(my + hop + n) % n``; ``src =
-1`` skips the row.  Sources must not be destinations of the same call
(a row reading the block it writes is a no-op and allowed); two rows
writing one block, an id outside its slab or a hop outside ``(-n, n)``
are refused on the host before any launch.

The port widens a row to ``[table, my, src, dst, hop]`` so that ONE launch
serves every rank and every pool of a call: ``table`` picks a pair of
per-rank slab lists (sources, destinations), so the sharded drain pushes
every pool's transfers into the receivers' buffers at once.  On one card
the slabs of all ranks are local memory; on several cards with peer
access the destination addresses are peer addresses, and the wrapper
launches once per source card.

:func:`check_rows` states the contract on tensors and is the plain path's
check.  On the card the wrapper makes ONE C call per source card, which
checks the rows, plans and launches (``csrc/psm_transfer.cu``);
:func:`plan_rows` states that plan in Python (the same refusals, the rows
kept and resolved to the launch parameters' layout, the route and
:func:`~repro_torch.kernels.fpm_copy.chunking`), the CPU tests pin it to
:func:`check_rows`, and ``chip_smoke.py`` holds the library's plan
(:func:`plan`) against it.

Bound on the card: bytes (each row reads and writes one block: L pages of
a layer-stacked slab).
"""
from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.fpm_copy import chunking, sm_count
from repro_torch.kernels.ref import require_live

#: launches of the PSM transfer kernel (K7)
COUNTER = LaunchCounter("psm_transfer")

# design constants of csrc/psm_transfer.cu (``chip_smoke.py`` checks them
# against the library's ``rc_psm_constants``)
#: rows the launch parameters carry (``kRowCap``; 24-byte rows under 4 KB);
#: above it the rows go through a pinned host and a device buffer
ROW_CAPACITY = 169
#: chunk slots of the bulk route's ring, and bulk loads in flight a CTA
STAGES, LOOKAHEAD = 4, 3
#: int64 words of one slab record (base address, blocks, card) and of one
#: row; bytes of a row as the kernel reads it (source and destination
#: addresses, the two slabs' block counts as int32)
SLAB_WORDS, ROW_WORDS, ROW_BYTES = 3, 5, 24
#: bytes of the launch parameters: a 40-byte head and the rows
PARAM_BYTES = 40 + ROW_CAPACITY * ROW_BYTES
#: words of the ``out`` array a C entry fills: rows launched, work items,
#: grid, chunk bytes, chunks per page, bulk route, word bytes, rows through
#: the device buffer, refused row, the row it reads from (RAW)
OUT_WORDS = 10
#: the library's refusal codes: a table, rank or hop outside the call, a
#: block outside its slab, two rows writing one block, a row reading a
#: block another row writes; and a missing row buffer
OUTSIDE, BLOCK_OUTSIDE, WAW, RAW, NO_ROW_BUFFER = -1, -2, -3, -4, -5

#: a pair of per-rank slab lists: (sources, destinations), rank order
Table = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]


def rank_rows(ids, n: int, table: int = 0) -> np.ndarray:
    """The reference's per-rank ids as wide rows: ``ids`` (n, m, 3) (rank
    ``i``'s rows ``[src_local, dst_local, hop]`` at ``ids[i]``) -> (k, 5)
    int64 ``[table, my, src, dst, hop]`` for the live rows (``src >=
    0``), in rank order."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    a = np.asarray(ids, np.int64).reshape(-1, 3)
    live = np.flatnonzero(a[:, 0] >= 0)
    out = np.empty((len(live), ROW_WORDS), np.int64)
    out[:, 0] = table
    out[:, 1] = live // (len(a) // n)
    out[:, 2:] = a[live]
    return out


def refusal(code: int, rows: np.ndarray, i: int, j: int, n_tables: int,
            n: int) -> ValueError:
    """The error of a refused call, naming row ``i`` (and, for a row that
    reads a block another row writes, that row ``j``)."""
    row = rows[i].tolist()
    if code == OUTSIDE:
        return ValueError(f"row {row} names a table, rank or hop outside "
                          f"the call ({n_tables} tables, {n} ranks)")
    if code == BLOCK_OUTSIDE:
        return ValueError(f"row {row} names a block outside its slab")
    if code == WAW:
        return ValueError(f"row {row} writes a block another row of the "
                          "call writes")
    return ValueError(f"row {row} reads a block row {rows[j].tolist()} of "
                      "the call writes")


def check_rows(tables: Sequence[Table], rows, block_axis: int
               ) -> np.ndarray:
    """Validate one call's rows against its tables on the host and return
    them as (k, 5) int64.  Raises ``ValueError`` for a table whose slabs
    differ in block shape or dtype (a block moves bit for bit), a table or
    rank outside the call, a hop outside ``(-n, n)``, a block outside its
    slab,
    two rows writing one block, or a row reading a block another row
    writes (the reference's "sources disjoint from in-flight
    destinations")."""
    r = np.asarray(rows, np.int64).reshape(-1, ROW_WORDS)
    if not len(r):
        return r
    n = len(tables[0][0])
    for src, dst in tables:
        if len(src) != n or len(dst) != n:
            raise ValueError(f"every table needs one slab per rank ({n})")
        if len({(t.dtype, tuple(t.shape[block_axis + 1:]),
                 t.shape[0] if block_axis else 1)
                for t in (*src, *dst)}) > 1:
            raise ValueError("a table's slabs must share block shape and "
                             "dtype")
    nt = len(tables)
    tab, my, s, d, hop = r.T
    bad = (tab < 0) | (tab >= nt) | (my < 0) | (my >= n) | \
        (hop <= -n) | (hop >= n)
    if bad.any():
        raise refusal(OUTSIDE, r, int(np.flatnonzero(bad)[0]), -1, nt, n)
    tgt = (my + hop + n) % n
    nblk = np.array([[[int(t.shape[block_axis]) for t in side]
                      for side in table] for table in tables], np.int64)
    bad = (s < 0) | (s >= nblk[tab, 0, my]) | (d < 0) | \
        (d >= nblk[tab, 1, tgt])
    if bad.any():
        raise refusal(BLOCK_OUTSIDE, r, int(np.flatnonzero(bad)[0]), -1, nt,
                      n)
    # blocks keyed by the storage they live in: tables may share slabs
    ident: Dict[Tuple, int] = {}

    def key_of(t: torch.Tensor) -> int:
        return ident.setdefault((t.device, t.data_ptr()), len(ident))

    src_key = np.array([[key_of(t) for t in table[0]] for table in tables],
                       np.int64)[tab, my] * (1 << 40) + s
    dst_key = np.array([[key_of(t) for t in table[1]] for table in tables],
                       np.int64)[tab, tgt] * (1 << 40) + d
    order = np.argsort(dst_key, kind="stable")
    sorted_dst = dst_key[order]
    dup = np.flatnonzero(sorted_dst[1:] == sorted_dst[:-1])
    if len(dup):
        raise refusal(WAW, r, int(order[dup[0] + 1]), -1, nt, n)
    at = np.minimum(np.searchsorted(sorted_dst, src_key), len(r) - 1)
    j = order[at]
    bad = np.flatnonzero((sorted_dst[at] == src_key)
                         & (j != np.arange(len(r))))
    if len(bad):
        i = int(bad[0])
        raise refusal(RAW, r, i, int(j[i]), nt, n)
    return r


# ---------------------------------------------------------------------------
# the plan of one call, as the library makes it
# ---------------------------------------------------------------------------

def plan_rows(slabs, n: int, rows, card: int, *, layers: int,
              page_bytes: int, sms: int):
    """The library's plan of one call on ``card``, in Python: ``(code,
    launch rows, out)``.  ``slabs`` holds :data:`SLAB_WORDS` int64 per
    (table, side, rank) (base address, blocks, card); ``rows`` the raw
    ``[table, my, src, dst, hop]`` rows.  ``code`` is 0 or the refusal
    (``out[8]`` the refused row, ``out[9]`` the row it reads from), found
    as ``csrc/psm_transfer.cu`` finds it: a table, rank or hop outside the
    call (a first pass), a block outside its slab (a second pass), the
    first equal pair of destination keys in key order (WAW), the first row
    whose source key is another row's destination key (RAW), a key being
    the slab's identity (the order in which its (card, base) first
    appears, sources before destinations) and the block.  The launch rows
    (:func:`launch_rows`) are those whose source slab lies on ``card``, in
    row order; ``out`` holds the :data:`OUT_WORDS` words."""
    r = np.asarray(rows, np.int64).reshape(-1, ROW_WORDS)
    rec = np.asarray(slabs, np.int64).reshape(-1, 2, n, SLAB_WORDS)
    nt = len(rec)
    out = np.zeros(OUT_WORDS, np.int64)
    out[8:] = -1
    empty = np.zeros((0, 3), np.int64)
    if not len(r):
        return 0, empty, out
    tab, my, s, d, hop = r.T
    bad = (tab < 0) | (tab >= nt) | (my < 0) | (my >= n) | \
        (hop <= -n) | (hop >= n)
    if bad.any():
        out[8] = np.flatnonzero(bad)[0]
        return OUTSIDE, empty, out
    tgt = (my + hop + n) % n
    src, dst = rec[tab, 0, my], rec[tab, 1, tgt]
    bad = (s < 0) | (s >= src[:, 1]) | (d < 0) | (d >= dst[:, 1])
    if bad.any():
        out[8] = np.flatnonzero(bad)[0]
        return BLOCK_OUTSIDE, empty, out
    seen: Dict[Tuple[int, int], int] = {}
    ident = np.zeros((nt, 2, n), np.int64)
    for side in (0, 1):
        for t in range(nt):
            for k in range(n):
                key = (int(rec[t, side, k, 2]), int(rec[t, side, k, 0]))
                ident[t, side, k] = seen.setdefault(key, len(seen))
    src_key = (ident[tab, 0, my] << 40) + s
    dst_key = (ident[tab, 1, tgt] << 40) + d
    order = np.argsort(dst_key, kind="stable")
    keys = dst_key[order]
    dup = np.flatnonzero(keys[1:] == keys[:-1])
    if len(dup):
        out[8] = order[dup[0] + 1]
        return WAW, empty, out
    at = np.minimum(np.searchsorted(keys, src_key), len(r) - 1)
    j = order[at]
    raw = np.flatnonzero((keys[at] == src_key) & (j != np.arange(len(r))))
    if len(raw):
        out[8], out[9] = raw[0], j[raw[0]]
        return RAW, empty, out
    word = 16
    while page_bytes % word or (rec[..., 0] % word).any():
        word //= 2
    mine = src[:, 2] == card
    kept = launch_rows(src[mine], dst[mine], s[mine], d[mine], page_bytes)
    bulk = word == 16
    chunk, cpp, items, grid = chunking(len(kept), layers, page_bytes,
                                       bulk=bulk, zero=False, sms=sms,
                                       buffers=STAGES)
    out[:8] = (len(kept), items, grid, chunk, cpp, bulk, word,
               len(kept) > ROW_CAPACITY)
    return 0, kept, out


def launch_rows(src, dst, s, d, page_bytes: int) -> np.ndarray:
    """The ``(k, 3)`` int64 words of the kernel's rows (``Row`` in
    csrc/psm_transfer.cu) for source and destination slab records
    (``(k, 3)`` each) and block ids: the source block's address, the
    destination block's, and the two slabs' block counts as two int32
    (source in the low half)."""
    out = np.empty((len(s), 3), np.int64)
    out[:, 0] = src[:, 0] + s * page_bytes
    out[:, 1] = dst[:, 0] + d * page_bytes
    out[:, 2] = src[:, 1] | (dst[:, 1] << 32)
    return out


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

_SIGNATURE = {
    "rc_psm_transfer": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    "rc_psm_plan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "rc_enable_peer": [ctypes.c_int, ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    """A C entry of ``csrc/psm_transfer.cu``, typed once."""
    fn = getattr(library("psm_transfer"), entry)
    fn.argtypes = _SIGNATURE[entry]
    fn.restype = ctypes.c_int
    return fn


def constants() -> dict:
    """The design constants as this module states them."""
    return dict(ROW_CAPACITY=ROW_CAPACITY, STAGES=STAGES,
                LOOKAHEAD=LOOKAHEAD, SLAB_WORDS=SLAB_WORDS,
                ROW_WORDS=ROW_WORDS, ROW_BYTES=ROW_BYTES,
                PARAM_BYTES=PARAM_BYTES, OUT_WORDS=OUT_WORDS)


def library_constants() -> dict:
    """The design constants as the library has them (needs the card)."""
    fn = library("psm_transfer").rc_psm_constants
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    out = np.zeros(8, np.int64)
    fn(out.ctypes.data)
    return dict(zip(constants(), out.tolist()))


def plan(slabs, n: int, rows, card: int, *, layers: int, page_bytes: int,
         sms: int):
    """The library's plan of one call without a launch (needs the card's
    build): ``(code, launch rows, out)`` as :func:`plan_rows` gives
    them."""
    rec = np.ascontiguousarray(slabs, np.int64).reshape(-1, SLAB_WORDS)
    r = np.ascontiguousarray(rows, np.int64).reshape(-1, ROW_WORDS)
    kept = np.zeros((max(len(r), 1), 3), np.int64)
    out = np.zeros(OUT_WORDS, np.int64)
    code = _entry("rc_psm_plan")(
        rec.ctypes.data, len(rec) // (2 * n), n, r.ctypes.data, len(r), card,
        layers, page_bytes, sms, kept.ctypes.data, len(kept),
        out.ctypes.data)
    return code, kept[:int(out[0]) if code == 0 else 0], out


def slab_records(tables: Sequence[Table], block_axis: int):
    """``(records, layers, page_bytes, devices)`` of a call's slabs on the
    card: :data:`SLAB_WORDS` int64 per (table, side, rank) and the devices
    holding slabs, by card index.  Raises ``ValueError``
    with :func:`check_rows`'s message for a table without a slab per rank
    or with slabs of two block shapes or dtypes, and for slabs that are
    not CUDA or not contiguous, or whose tables differ in block shape or
    dtype (one launch moves one page size); ``RuntimeError`` for a killed
    slab."""
    n = len(tables[0][0])
    ba = block_axis
    words = []
    devices: Dict[int, torch.device] = {}
    # each distinct slab is read once: (its kind, its record); equal kinds
    # are one object, compared by identity
    seen: Dict[int, Tuple[Tuple, Tuple[int, int, int]]] = {}
    kinds: Dict[Tuple, Tuple] = {}
    kind = None
    for src, dst in tables:
        if len(src) != n or len(dst) != n:
            raise ValueError(f"every table needs one slab per rank ({n})")
        own = None
        for t in (*src, *dst):
            held = seen.get(id(t))
            if held is None:
                if not t.is_cuda:
                    raise ValueError("K7 moves CUDA slabs only")
                if not t.is_contiguous():
                    raise ValueError("slabs must be contiguous")
                if not t.untyped_storage().nbytes():
                    require_live((t,))
                shape, dev = t.shape, t.device
                devices.setdefault(dev.index, dev)
                k = (t.dtype, shape[ba + 1:], shape[0] if ba else 1)
                held = seen[id(t)] = (kinds.setdefault(k, k), (
                    t.data_ptr(), shape[ba], dev.index))
            if own is None:
                own = held[0]
            elif held[0] is not own:
                raise ValueError("a table's slabs must share block shape "
                                 "and dtype")
            words += held[1]
        if kind is None:
            kind = own
        elif own is not kind:
            raise ValueError("slabs must share block shape and dtype")
    page_bytes = math.prod(kind[1]) * tables[0][0][0].element_size()
    return (np.frombuffer(array.array("q", words), np.int64), int(kind[2]),
            page_bytes, devices)


#: per (device, stream), the device buffer and the pinned host buffer that
#: take a call's rows above :data:`ROW_CAPACITY`, and the event the library
#: records after each copy out of the pinned one (and waits for before it
#: rewrites it); grown when a call needs more
_BUFFERS: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor,
                                      torch.cuda.Event]] = {}
#: the ``out`` words of the last C call (read by ``chip_smoke.py``)
last_out = np.zeros(OUT_WORDS, np.int64)
_LAST_OUT_PTR = last_out.ctypes.data


def _row_buffers(device: torch.device, stream: int, n_rows: int):
    """(device buffer, pinned buffer, event) of ``stream``, room for at
    least ``n_rows`` rows; the event is recorded once here, so that the
    library can wait for it."""
    key = (device.index, stream)
    held = _BUFFERS.get(key)
    if held is None or held[0].numel() < n_rows * ROW_BYTES:
        if held is not None:
            held[2].synchronize()   # torch does not know of that copy
        nbytes = max(n_rows, 4 * ROW_CAPACITY) * ROW_BYTES
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        held = _BUFFERS[key] = (
            torch.empty(nbytes, dtype=torch.uint8, device=device),
            torch.empty(nbytes, dtype=torch.uint8, pin_memory=True), event)
    return held


def _enable_peers(cards) -> None:
    """Peer access between every two of ``cards`` (enabling twice is
    fine)."""
    for dev in cards:
        for peer in cards:
            if dev != peer:
                check(_entry("rc_enable_peer")(dev, peer),
                      f"peer access {dev} -> {peer}")


def psm_transfer_cuda(tables: Sequence[Table], rows, *,
                      block_axis: int) -> int:
    """Run raw rows on the card, in place: ONE C call per card holding
    source slabs, which checks every row as :func:`check_rows` does,
    plans and makes ONE launch of K7 for the rows whose source lies on
    that card (none without rows), on that card's current stream.  Raises
    ``ValueError`` with :func:`check_rows`'s message before any launch.
    With slabs on several cards, peer access is enabled between them and
    every such card is synchronized before and after the call.  Returns
    the launches."""
    r = np.ascontiguousarray(rows, np.int64).reshape(-1, ROW_WORDS)
    if not len(r):
        return 0
    slabs, layers, page_bytes, devices = slab_records(tables, block_axis)
    n, nt = len(tables[0][0]), len(tables)
    many = len(devices) > 1
    if many:
        _enable_peers(list(devices))
        for c in devices:
            torch.cuda.synchronize(c)
    srcs = {t.device.index for table in tables for t in table[0]} \
        if many else devices
    launches = 0
    for c in srcs:
        device = devices[c]
        stream = stream_ptr(device)
        pinned = dev_buf = done = None
        cap = 0
        if len(r) > ROW_CAPACITY:
            dev_buf, held, event = _row_buffers(device, stream, len(r))
            pinned, done = held.data_ptr(), event.cuda_event
            dev_buf, cap = dev_buf.data_ptr(), dev_buf.numel() // ROW_BYTES
        err = _entry("rc_psm_transfer")(
            slabs.ctypes.data, nt, n, r.ctypes.data, len(r), c, layers,
            page_bytes, sm_count(device), pinned, dev_buf, cap, done, stream,
            _LAST_OUT_PTR)
        if err < 0 and err != NO_ROW_BUFFER:
            raise refusal(err, r, int(last_out[8]), int(last_out[9]), nt, n)
        check(err, "psm transfer kernel")
        launches += bool(last_out[0])
    if many:
        for c in devices:
            torch.cuda.synchronize(c)
    COUNTER.n += launches
    return launches


__all__ = ["COUNTER", "ROW_CAPACITY", "rank_rows", "check_rows", "refusal",
           "plan_rows", "launch_rows", "plan", "constants",
           "library_constants", "slab_records", "psm_transfer_cuda"]
