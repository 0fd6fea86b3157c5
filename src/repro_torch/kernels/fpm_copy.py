"""K5a / K5b — FPM block copy, in-pool and pool-to-pool: the host wave
schedule and the CUDA wrappers.

Replaces the TPU kernels of ``repro/kernels/fpm_copy.py``:
``_fpm_copy_kernel`` (``fpm_copy_pallas``, the ``pallas_call`` at :60) and
``_fpm_copy_cross_kernel`` (``fpm_copy_cross_pallas``, :101).  The kernel is
``csrc/fpm_copy.cu`` over the shared body ``csrc/block_move.cuh``; the
plain versions are :func:`repro_torch.kernels.ref.fpm_copy` and
:func:`~repro_torch.kernels.ref.fpm_copy_cross`.

Bound on the card: bytes (each pair reads and writes one block: L pages of
a layer-stacked pool).  Sources see the pre-call state: the queue may put
a write-after-read pair into one call, and the GPU runs pairs
concurrently, so :func:`pair_waves` puts each writer in a later wave than
every earlier reader of its block, and the kernel gates the waves inside
ONE launch.  A RAW or WAW pair (which the command queue never flushes)
raises rather than copy differently from the plain version.

At the fan-out's sizes the device moves a call's blocks in tens of
microseconds, so the wrapper's host work decides the call's time: the
schedule is one table lookup per pair, :func:`block_descriptor` writes the
kernel's words straight into pinned memory, and the upload does not
block (a copy from pageable memory would wait for all queued work).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.fused_dispatch import (CHUNK_BYTES, CTAS_PER_SM,
                                                block_geometry)

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
    on the host: the wrappers schedule rows there.  A tensor on the card
    costs a copy that waits for the work queued before it; the engine's
    fan-out passes numpy and never takes that branch."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, np.int64).reshape(-1, width)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    """The C entry (``rc_fpm_copy`` or ``rc_zero_init``), its argument types
    set once when the library loads."""
    lib = library("fpm_copy" if entry == "rc_fpm_copy" else "zero_init")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def descriptor_words(n_rows: int, n_waves: int) -> int:
    """Length of :func:`block_descriptor`'s array."""
    return 11 + 2 * n_rows + n_waves + 1 + 2


def block_descriptor(dst_ptr: int, src_ptr: int, dst_nblk: int,
                     src_nblk: int, *, layers: int, page_bytes: int,
                     word: int, rows: np.ndarray, waves: np.ndarray,
                     out: np.ndarray = None) -> np.ndarray:
    """The int64 words ``csrc/block_move.cuh`` reads for the live ``(n, 2)``
    ``[src, dst]`` rows and their waves: the 11-word header, the rows
    sorted by wave (stable), the ``n_waves + 1`` work-item prefix sums
    (``layers x chunks_per_page`` items per row) and two zeroed counters.
    Writes into the front of ``out`` (a pinned buffer's numpy view) when
    given."""
    n = len(rows)
    n_waves = int(waves.max()) + 1
    chunk = min(CHUNK_BYTES, page_bytes)
    cpp = -(-page_bytes // chunk)
    words = descriptor_words(n, n_waves)
    desc = np.empty(words, np.int64) if out is None else out[:words]
    desc[:11] = (dst_ptr, src_ptr, dst_nblk, src_nblk, layers, page_bytes,
                 n, chunk, cpp, n_waves, word)
    if n_waves == 1:                 # the common case: no sort, no count
        desc[11:11 + 2 * n] = rows.reshape(-1)
        desc[11 + 2 * n:] = (0, n * layers * cpp, 0, 0)
        return desc
    desc[11:11 + 2 * n] = rows[np.argsort(waves, kind="stable")].reshape(-1)
    prefix = desc[11 + 2 * n:words - 2]
    prefix[0] = 0
    np.cumsum(np.bincount(waves, minlength=n_waves) * (layers * cpp),
              out=prefix[1:])
    desc[-2:] = 0
    return desc


def pinned_descriptor(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                      rows: np.ndarray, waves: np.ndarray, *,
                      block_axis: int):
    """:func:`block_descriptor` for the live ``(n, 2)`` ``[src, dst]`` rows
    of one call, written into a pinned host tensor of exactly its length.
    Returns that tensor and the call's work items."""
    layers, page_bytes, word = block_geometry((dst_pool, src_pool),
                                              block_axis)
    host = torch.empty(descriptor_words(len(rows), int(waves.max()) + 1),
                       dtype=torch.int64, pin_memory=True)
    desc = block_descriptor(
        dst_pool.data_ptr(), src_pool.data_ptr(),
        int(dst_pool.shape[block_axis]), int(src_pool.shape[block_axis]),
        layers=layers, page_bytes=page_bytes, word=word, rows=rows,
        waves=waves, out=host.numpy())
    return host, int(desc[-3])


def launch_descriptor(entry: str, desc: torch.Tensor, items: int) -> None:
    """Launch ``entry`` (``rc_fpm_copy`` or ``rc_zero_init``) once over the
    descriptor ``desc`` on the card, on the current stream."""
    device = desc.device
    grid = max(1, min(items, _sm_count(device) * CTAS_PER_SM))
    ptr = desc.data_ptr()
    check(_entry(entry)(ptr, ptr + 8 * (len(desc) - 2), grid,
                        stream_ptr(device)), entry)


def block_move(entry: str, dst_pool: torch.Tensor, src_pool: torch.Tensor,
               rows: np.ndarray, waves: np.ndarray, *,
               block_axis: int) -> None:
    """Launch ``entry`` once over the live ``(n, 2)`` ``[src, dst]`` rows,
    in wave order.  The descriptor is built in pinned host memory and
    copied without blocking: PyTorch's caching host allocator keeps the
    pinned block until the copy that reads it has run, and the kernel
    follows the copy on the same stream."""
    host, items = pinned_descriptor(dst_pool, src_pool, rows, waves,
                                    block_axis=block_axis)
    launch_descriptor(entry, host.to(dst_pool.device, non_blocking=True),
                      items)


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
    n = int(pool.shape[block_axis])
    rows = _live_pairs(ids, n, n)
    if len(rows):
        block_move("rc_fpm_copy", pool, pool, rows, pair_waves(rows),
                   block_axis=block_axis)
        COUNTER.n += 1
    return pool


def fpm_copy_cross_cuda(dst_pool: torch.Tensor, src_pool: torch.Tensor, ids,
                        *, block_axis: int) -> torch.Tensor:
    """Pool-to-pool copy ``dst_pool[dst] = src_pool[src]`` on the card, in
    place, with ONE launch of K5b (none when every row is padding).  The
    two pools may be one tensor; then in-call WAR pairs are ordered as in
    K5a."""
    rows = _live_pairs(ids, int(src_pool.shape[block_axis]),
                       int(dst_pool.shape[block_axis]))
    if len(rows):
        same = dst_pool.data_ptr() == src_pool.data_ptr()
        block_move("rc_fpm_copy", dst_pool, src_pool, rows,
                   pair_waves(rows, same_pool=same), block_axis=block_axis)
        CROSS_COUNTER.n += 1
    return dst_pool


__all__ = ["COUNTER", "CROSS_COUNTER", "pair_waves", "host_ids",
           "block_descriptor", "descriptor_words", "pinned_descriptor",
           "launch_descriptor", "block_move",
           "fpm_copy_cuda", "fpm_copy_cross_cuda"]
