"""K5a / K5b — FPM block copy, in-pool and pool-to-pool: the wave schedule
and the CUDA wrappers.

Replaces the TPU kernels of ``repro/kernels/fpm_copy.py``:
``_fpm_copy_kernel`` (``fpm_copy_pallas``, the ``pallas_call`` at :60) and
``_fpm_copy_cross_kernel`` (``fpm_copy_cross_pallas``, :101).  The kernel is
``csrc/fpm_copy.cu`` over the shared body ``csrc/block_move.cuh``; the
plain versions are :func:`repro_torch.kernels.ref.fpm_copy` and
:func:`~repro_torch.kernels.ref.fpm_copy_cross`.

Bound on the card: bytes (each pair reads and writes one block: L pages of
a layer-stacked pool).  Sources see the pre-call state: the queue may put
a write-after-read pair into one call, and the GPU runs pairs
concurrently, so each writer goes in a later wave than every earlier
reader of its block, and the kernel gates the waves inside ONE launch.  A
RAW or WAW pair (which the command queue never flushes) raises rather
than copy differently from the plain version.

At the fan-out's sizes the device moves a call's blocks in microseconds,
so the host work decides the call's time.  The wrapper makes ONE C call:
the library drops padding, clips sources, assigns waves, sorts the rows
and passes them to the kernel as launch parameters, without a device
allocation or a host-to-device copy (up to :data:`ROW_CAPACITY` live
rows).  :func:`_live_pairs` and :func:`pair_waves` state that schedule in
Python, :func:`launch_rows` and :func:`chunking` the launch's layout; the
CPU tests pin them, and ``chip_smoke.py`` holds the library's schedule
against them.  :func:`block_geometry`, :func:`sm_count`,
:func:`stream_counters` and :func:`chunking` serve K1's wrapper too
(``kernels/fused_dispatch.py``), whose kernel shares ``block_move.cuh``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.ref import require_live

#: launches of the in-pool copy kernel (K5a)
COUNTER = LaunchCounter("fpm_copy")
#: launches of the pool-to-pool copy kernel (K5b)
CROSS_COUNTER = LaunchCounter("fpm_copy_cross")


def pair_waves(pairs, same_pool: bool = True) -> np.ndarray:
    """The wave of each ``(src, dst)`` pair of block ids (>= 0): 0, or 1 +
    the largest wave of an EARLIER pair reading this pair's destination.  Running the waves in
    order, the pairs of one wave in any order, equals gather-then-scatter.
    With ``same_pool=False`` sources and destinations lie in different
    pools and only a repeated destination can clash.  Raises
    ``ValueError`` on a RAW or WAW pair.  A table indexed by block id finds
    every clash without sorting; a call without a write-after-read pair
    (the common case) is one wave, and only the write-after-read edges are
    walked in Python."""
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    src, dst = p[:, 0], p[:, 1]
    n = len(p)
    waves = np.zeros(n, np.int64)
    if n < 2:
        return waves
    idx = np.arange(n)
    # writer[b]: the pair writing block b, n for a source nobody writes
    writer = np.empty(int(p.max()) + 1, np.int64)
    writer[src] = n
    writer[dst] = idx
    if (writer[dst] != idx).any():
        _, first = np.unique(dst, return_index=True)
        i = np.setdiff1d(idx, first)[0]
        raise ValueError(f"pair {tuple(p[i])} rewrites a block an earlier "
                         "pair writes (WAW)")
    if not same_pool:
        return waves
    w = writer[src]
    raw = np.flatnonzero(w < idx)
    if len(raw):
        raise ValueError(f"pair {tuple(p[raw[0]])} reads a block an "
                         "earlier pair writes (RAW)")
    # write-after-read edges reader j -> later writer i of j's source; by
    # ascending writer, every edge into a reader is settled before it
    readers = np.flatnonzero((w > idx) & (w < n))
    for i, j in sorted(zip(w[readers].tolist(), readers.tolist())):
        waves[i] = max(waves[i], waves[j] + 1)
    return waves


def host_ids(ids, width: int) -> np.ndarray:
    """Block ids (numpy, list or tensor) as an ``(m, width)`` int64 array
    on the host, for the Python schedule (:func:`id_array`)."""
    return id_array(ids, width).astype(np.int64, copy=False)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, asked once per device (K1, K5 and K6 size
    their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_geometry(pools: Sequence[torch.Tensor], block_axis: int
                   ) -> Tuple[int, int, int]:
    """(layers, page_bytes, word_bytes) of pools that share one device,
    dtype and block shape; raises on what the kernels do not take.
    ``word_bytes`` is the widest access (16, 8, ... 1 bytes) that divides
    the page size and every pool's base address.  A pool whose storage
    was freed raises here, before any address is read."""
    require_live(pools)
    p0 = pools[0]
    blk = tuple(p0.shape[block_axis + 1:])
    layers = int(p0.shape[0]) if block_axis == 1 else 1
    for p in pools:
        if not p.is_cuda or p.device != p0.device:
            raise ValueError("every pool must be on one CUDA device")
        if p.dtype != p0.dtype or tuple(p.shape[block_axis + 1:]) != blk \
                or (block_axis == 1 and p.shape[0] != layers):
            raise ValueError("pools must share block shape and dtype")
        if not p.is_contiguous():
            raise ValueError("pools must be contiguous")
    page_bytes = math.prod(blk) * p0.element_size()
    word = 16
    while page_bytes % word or any(p.data_ptr() % word for p in pools):
        word //= 2
    return layers, page_bytes, word


# design constants of csrc/block_move.cuh (``chip_smoke.py`` checks them
# against the library's ``rc_block_move_constants``)
#: live rows the launch parameters carry; above it the rows go through a
#: device buffer (the parameters stay under 4 KB)
ROW_CAPACITY = 320
#: chunk buffers of K5's shared-memory ring
STAGES = 4
#: chunk bytes of the bulk path: at least, at most
MIN_CHUNK, MAX_CHUNK = 4 * 1024, 32 * 1024
#: work items per SM the bulk path's chunk size aims at
ITEMS_PER_SM = 2
#: resident CTAs per SM the grid is sized for, and the shared memory an SM
#: lends them
MAX_CTAS_PER_SM, SMEM_PER_SM = 8, 227 * 1024
#: the library's return codes for a refused pair and a missing row buffer
RAW, WAW, NO_ROW_BUFFER = -1, -2, -3
#: words of the ``out`` array a C entry fills: live rows, refused pair (2),
#: work items, grid, chunk bytes, waves, bulk path
OUT_WORDS = 8

_SIGNATURE = {
    "rc_fpm_copy": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p],
    "rc_zero_init": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p],
    "rc_block_plan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    """A C entry of ``csrc/fpm_copy.cu`` or ``csrc/zero_init.cu``, its
    argument types set once when the library loads."""
    lib = library("zero_init" if entry == "rc_zero_init" else "fpm_copy")
    fn = getattr(lib, entry)
    fn.argtypes = _SIGNATURE[entry]
    fn.restype = ctypes.c_int
    return fn


def library_constants() -> dict:
    """The design constants as the library has them (needs the card)."""
    fn = library("fpm_copy").rc_block_move_constants
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    out = np.zeros(8, np.int64)
    fn(out.ctypes.data)
    names = ("ROW_CAPACITY", "STAGES", "MIN_CHUNK", "MAX_CHUNK",
             "ITEMS_PER_SM", "MAX_CTAS_PER_SM", "SMEM_PER_SM")
    return dict(zip(names, out.tolist()), param_bytes=int(out[7]))


def launch_rows(rows: np.ndarray, waves: np.ndarray) -> np.ndarray:
    """The ``(n, 3)`` int32 rows the kernel gets for the live ``(n, 2)``
    ``[src, dst]`` rows and their waves: ``[src, dst, first]``, sorted by
    wave (stable), ``first`` the index of the first row of the row's wave
    (its items wait until every item before that row has been read)."""
    waves = np.asarray(waves, np.int64)
    order = np.argsort(waves, kind="stable")
    first = np.searchsorted(waves[order], waves[order], side="left")
    out = np.empty((len(order), 3), np.int32)
    out[:, :2] = np.asarray(rows).reshape(-1, 2)[order]
    out[:, 2] = first
    return out


def chunking(n_rows: int, layers: int, page_bytes: int, *, bulk: bool,
             zero: bool, sms: int, buffers: Optional[int] = None):
    """(chunk bytes, chunks per page, work items, grid) of a call over
    ``n_rows`` live rows.  The bulk path aims at :data:`ITEMS_PER_SM` items
    per SM, 4-32 KiB, and splits a page evenly in multiples of 16 bytes;
    its grid is what the SMs' shared memory holds: ``buffers`` chunks a CTA
    (by default a ring of :data:`STAGES` chunks for a copy, one tile for
    K6).  The word path (pages not 16-byte aligned) moves 32 KiB chunks."""
    if buffers is None:
        buffers = 1 if zero else STAGES
    if bulk:
        slots = ITEMS_PER_SM * sms
        c = (-(-(n_rows * layers * page_bytes) // slots) + 15) // 16 * 16
        c = min(max(c, MIN_CHUNK), MAX_CHUNK)
        pieces = -(-page_bytes // c)
        c = (-(-page_bytes // pieces) + 15) // 16 * 16
        per_sm = SMEM_PER_SM // (buffers * c + 1024)
        per_sm = min(max(per_sm, 1), MAX_CTAS_PER_SM)
    else:
        c = min(page_bytes, MAX_CHUNK)
        per_sm = MAX_CTAS_PER_SM
    cpp = -(-page_bytes // c)
    items = n_rows * layers * cpp
    return c, cpp, items, max(1, min(items, sms * per_sm))


def id_array(ids, width: int) -> np.ndarray:
    """Block ids (numpy, list or tensor) as a contiguous ``(m, width)``
    int32 or int64 host array, without a copy when they already are one.
    A tensor on the card costs a copy that waits for the work queued
    before it; the engine's fan-out passes numpy and never takes that
    branch."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    a = np.asarray(ids)
    if a.dtype != np.int32 and a.dtype != np.int64:
        a = a.astype(np.int64)
    return np.ascontiguousarray(a).reshape(-1, width)


#: the counters of each (device, stream): next item, items read, CTAs out
_COUNTERS = {}
#: the ``out`` words of the last call (read by ``chip_smoke.py``)
last_out = np.zeros(OUT_WORDS, np.int64)
_LAST_OUT_PTR = last_out.ctypes.data


def stream_counters(device: torch.device, stream: int) -> int:
    """The address of the work counters of ``stream`` on ``device``,
    allocated once.  K1, K5 and K6 share them: calls on one stream run in
    order, and each call's last CTA resets them."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        # zeroed on the stream that uses it; the kernel resets it after
        buf = _COUNTERS[key] = torch.zeros(3, dtype=torch.int64,
                                           device=device)
    return buf.data_ptr()


def block_move(entry: str, dst_pool: torch.Tensor, src_pool: torch.Tensor,
               ids, *, block_axis: int) -> int:
    """ONE C call of ``entry`` (``rc_fpm_copy`` or ``rc_zero_init``) over
    the raw ids on the card, on the current stream: schedule and launch
    (none without live rows).  Returns the live rows.  Raises ``ValueError``
    on a RAW or WAW pair, with :func:`pair_waves`'s message, and
    ``RuntimeError`` when the launch is refused."""
    layers, page_bytes, _ = block_geometry((dst_pool, src_pool), block_axis)
    zero = entry == "rc_zero_init"
    a = id_array(ids, 1 if zero else 2)
    m = len(a)
    device = dst_pool.device
    stream = stream_ptr(device)
    rows_buf, cap = None, 0
    if m > ROW_CAPACITY:
        # live rows above the parameters' room go through device memory
        rows_buf = torch.empty(3 * m, dtype=torch.int32, device=device)
        cap = m
    counters = stream_counters(device, stream)
    nblk = int(dst_pool.shape[block_axis])
    buf = None if rows_buf is None else rows_buf.data_ptr()
    if zero:
        err = _entry(entry)(a.ctypes.data, a.itemsize, m,
                            dst_pool.data_ptr(), nblk, layers, page_bytes,
                            counters, buf, cap, sm_count(device), stream,
                            _LAST_OUT_PTR)
    else:
        err = _entry(entry)(a.ctypes.data, a.itemsize, m,
                            dst_pool.data_ptr(), src_pool.data_ptr(), nblk,
                            int(src_pool.shape[block_axis]), layers,
                            page_bytes,
                            int(dst_pool.data_ptr() == src_pool.data_ptr()),
                            counters, buf, cap, sm_count(device), stream,
                            _LAST_OUT_PTR)
    if err in (RAW, WAW):
        pair = tuple(np.asarray(last_out[1:3], np.int64))
        if err == WAW:
            raise ValueError(f"pair {pair} rewrites a block an earlier "
                             "pair writes (WAW)")
        raise ValueError(f"pair {pair} reads a block an earlier pair "
                         "writes (RAW)")
    check(err, entry)
    return int(last_out[0])


def plan(ids, width: int, n_src: int, n_dst: int, *, same_pool: bool,
         layers: int, page_bytes: int, bulk: bool, sms: int):
    """The library's schedule of one call without a launch (needs the
    card's build): ``(code, rows, out)``, ``rows`` the ``(n, 3)`` launch
    rows, ``out`` the :data:`OUT_WORDS` words."""
    a = id_array(ids, width)
    rows = np.zeros((max(len(a), 1), 3), np.int32)
    out = np.zeros(OUT_WORDS, np.int64)
    code = _entry("rc_block_plan")(a.ctypes.data, a.itemsize, len(a), width,
                                   n_src, n_dst, int(same_pool), layers,
                                   page_bytes, int(bulk), sms,
                                   rows.ctypes.data, out.ctypes.data)
    return code, rows[:int(out[0])], out


def _live_pairs(ids, n_src: int, n_dst: int) -> np.ndarray:
    """Rows with a destination in range, ``(n, 2)``; sources clipped as
    the plain version clips them."""
    a = host_ids(ids, 2)
    # a negative id is above every block id as uint64: one compare
    a = a.compress(a[:, 1].view(np.uint64) < n_dst, axis=0)
    a[:, 0].clip(0, n_src - 1, out=a[:, 0])
    return a


def fpm_copy_cuda(pool: torch.Tensor, ids, *, block_axis: int
                  ) -> torch.Tensor:
    """In-pool copy ``pool[dst] = pool[src]`` on the card, in place, with
    ONE launch of K5a (none when every row is padding)."""
    if block_move("rc_fpm_copy", pool, pool, ids, block_axis=block_axis):
        COUNTER.n += 1
    return pool


def fpm_copy_cross_cuda(dst_pool: torch.Tensor, src_pool: torch.Tensor, ids,
                        *, block_axis: int) -> torch.Tensor:
    """Pool-to-pool copy ``dst_pool[dst] = src_pool[src]`` on the card, in
    place, with ONE launch of K5b (none when every row is padding).  The
    two pools may be one tensor; then in-call WAR pairs are ordered as in
    K5a."""
    if block_move("rc_fpm_copy", dst_pool, src_pool, ids,
                  block_axis=block_axis):
        CROSS_COUNTER.n += 1
    return dst_pool


__all__ = ["COUNTER", "CROSS_COUNTER", "ROW_CAPACITY", "pair_waves",
           "host_ids", "id_array", "launch_rows", "chunking", "block_move",
           "block_geometry", "sm_count", "stream_counters",
           "plan", "library_constants", "fpm_copy_cuda",
           "fpm_copy_cross_cuda"]
