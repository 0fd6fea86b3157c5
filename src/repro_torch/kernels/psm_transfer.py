"""K7 — the PSM transfer: block pushes between the slabs of a rank mesh,
the host contract and the CUDA wrapper.

Replaces the TPU kernel ``_psm_kernel`` of ``repro/kernels/psm_transfer.py``
(``psm_transfer_pallas``, the ``pallas_call`` at :74), which pushed
slab-local blocks into the slab of the device at a signed hop along one
mesh axis with remote DMAs, ``PIPELINE_DEPTH`` of them in flight.  The
kernel is ``csrc/psm_transfer.cu`` over the word loop of
``csrc/block_move.cuh``; its plain version is
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

Bound on the card: bytes (each row reads and writes one block: L pages of
a layer-stacked slab).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.fpm_copy import sm_count
from repro_torch.kernels.ref import require_live

#: launches of the PSM transfer kernel (K7)
COUNTER = LaunchCounter("psm_transfer")

#: bytes of the kernel's work item at most (a page splits into chunks of
#: this size; csrc/psm_transfer.cu ``kChunk``)
CHUNK = 16 * 1024
#: CTAs per SM the grid is sized for (``kCtasPerSm``)
CTAS_PER_SM = 8
#: int64 words of one slab record (source base, source blocks, destination
#: base, destination blocks) and of one row
RECORD_WORDS, ROW_WORDS = 4, 5

#: a pair of per-rank slab lists: (sources, destinations), rank order
Table = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]


def rank_rows(ids, n: int, table: int = 0) -> np.ndarray:
    """The reference's per-rank ids as wide rows: ``ids`` (n, m, 3) (rank
    ``i``'s rows ``[src_local, dst_local, hop]`` at ``ids[i]``) -> (k, 5)
    int64 ``[table, my, src, dst, hop]`` for the live rows (``src >=
    0``), in rank order."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    a = np.asarray(ids, np.int64).reshape(n, -1, 3)
    my, j = np.nonzero(a[:, :, 0] >= 0)
    out = np.empty((len(my), ROW_WORDS), np.int64)
    out[:, 0] = table
    out[:, 1] = my
    out[:, 2:] = a[my, j]
    return out


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
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"row {r[i].tolist()} names a table, rank or hop "
                         f"outside the call ({nt} tables, {n} ranks)")
    tgt = (my + hop + n) % n
    nblk = np.array([[[int(t.shape[block_axis]) for t in side]
                      for side in table] for table in tables], np.int64)
    bad = (s < 0) | (s >= nblk[tab, 0, my]) | (d < 0) | \
        (d >= nblk[tab, 1, tgt])
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"row {r[i].tolist()} names a block outside its "
                         "slab")
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
        i = int(order[dup[0] + 1])
        raise ValueError(f"row {r[i].tolist()} writes a block another row "
                         "of the call writes")
    at = np.minimum(np.searchsorted(sorted_dst, src_key), len(r) - 1)
    j = order[at]
    bad = np.flatnonzero((sorted_dst[at] == src_key)
                         & (j != np.arange(len(r))))
    if len(bad):
        i = int(bad[0])
        raise ValueError(f"row {r[i].tolist()} reads a block row "
                         f"{r[j[i]].tolist()} of the call writes")
    return r


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

_SIGNATURE = {
    "rc_psm_transfer": [ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p],
    "rc_enable_peer": [ctypes.c_int, ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    """A C entry of ``csrc/psm_transfer.cu``, typed once."""
    fn = getattr(library("psm_transfer"), entry)
    fn.argtypes = _SIGNATURE[entry]
    fn.restype = ctypes.c_int
    return fn


def library_constants() -> dict:
    """The design constants as the library has them (needs the card)."""
    fn = library("psm_transfer").rc_psm_constants
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    out = np.zeros(4, np.int64)
    fn(out.ctypes.data)
    return dict(zip(("CHUNK", "CTAS_PER_SM", "RECORD_WORDS", "ROW_WORDS"),
                    out.tolist()))


def geometry(tables: Sequence[Table], block_axis: int
             ) -> Tuple[int, int, int]:
    """(layers, page_bytes, word_bytes) of every slab of a call: CUDA,
    contiguous, one dtype, one block shape; ``word_bytes`` the widest
    access (16 ... 1) dividing the page and every base address."""
    slabs = [t for table in tables for side in table for t in side]
    require_live(slabs)
    p0 = slabs[0]
    blk = tuple(p0.shape[block_axis + 1:])
    layers = int(p0.shape[0]) if block_axis == 1 else 1
    for t in slabs:
        if not t.is_cuda:
            raise ValueError("K7 moves CUDA slabs only")
        if t.dtype != p0.dtype or tuple(t.shape[block_axis + 1:]) != blk \
                or (block_axis == 1 and t.shape[0] != layers):
            raise ValueError("slabs must share block shape and dtype")
        if not t.is_contiguous():
            raise ValueError("slabs must be contiguous")
    page_bytes = math.prod(blk) * p0.element_size()
    word = 16
    while page_bytes % word or any(t.data_ptr() % word for t in slabs):
        word //= 2
    return layers, page_bytes, word


#: the device buffer of each (device, stream) that takes a call's slab
#: records and rows, grown when a call needs more
_BUFFERS: Dict[Tuple[int, int], torch.Tensor] = {}
#: the ``out`` words of the last launch: rows, work items, grid, chunk
last_out = np.zeros(4, np.int64)
_LAST_OUT_PTR = last_out.ctypes.data


def _buffer(device: torch.device, stream: int, nbytes: int
            ) -> Tuple[int, int]:
    key = (device.index, stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _BUFFERS[key] = torch.empty(max(nbytes, 1 << 16),
                                          dtype=torch.uint8, device=device)
    return buf.data_ptr(), buf.numel()


def _enable_peers(pairs) -> None:
    for dev, peer in pairs:
        check(_entry("rc_enable_peer")(dev, peer),
              f"peer access {dev} -> {peer}")


def psm_transfer_cuda(tables: Sequence[Table], rows: np.ndarray, *,
                      block_axis: int) -> int:
    """Run checked rows (:func:`check_rows`) on the card, in place: ONE C
    call and ONE launch of K7 per source card holding rows (none without
    rows), each on that card's current stream.  With ranks on several
    cards, peer access is enabled for the pairs the call uses and every
    card the call touches is synchronized before and after it.  Returns
    the launches."""
    if not len(rows):
        return 0
    layers, page_bytes, word = geometry(tables, block_axis)
    n = len(tables[0][0])
    rec = np.array([[(s.data_ptr(), s.shape[block_axis], d.data_ptr(),
                      d.shape[block_axis]) for s, d in zip(*table)]
                    for table in tables], np.int64).reshape(-1)
    # the card of each (table, rank)'s source and destination slab
    card = np.array([[[t.device.index for t in side] for side in table]
                     for table in tables], np.int64)
    tab, my = rows[:, 0], rows[:, 1]
    src_card = card[tab, 0, my]
    dst_card = card[tab, 1, (my + rows[:, 4] + n) % n]
    cards = np.unique(np.concatenate([src_card, dst_card])).tolist()
    if len(cards) > 1:
        pairs = np.unique(np.stack([src_card, dst_card], 1), axis=0)
        _enable_peers([(a, b) for a, b in pairs.tolist() if a != b])
        for c in cards:
            torch.cuda.synchronize(c)
    launches = 0
    for c in np.unique(src_card).tolist():
        part = np.ascontiguousarray(rows[src_card == c])
        device = torch.device("cuda", c)
        stream = stream_ptr(device)
        host = np.concatenate([rec, part.reshape(-1)])
        buf, cap = _buffer(device, stream, host.nbytes)
        err = _entry("rc_psm_transfer")(
            host.ctypes.data, len(rec), len(part), n, layers, page_bytes,
            word, buf, cap, c, sm_count(device), stream, _LAST_OUT_PTR)
        check(err, "psm transfer kernel")
        launches += 1
    if len(cards) > 1:
        for c in cards:
            torch.cuda.synchronize(c)
    COUNTER.n += launches
    return launches


__all__ = ["COUNTER", "CHUNK", "CTAS_PER_SM", "rank_rows", "check_rows",
           "geometry", "psm_transfer_cuda", "library_constants"]
