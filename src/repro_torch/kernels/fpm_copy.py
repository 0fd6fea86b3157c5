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
    """The wave of each ``(src, dst)`` pair: 0, or 1 + the largest wave of
    an EARLIER pair reading this pair's destination.  Running the waves in
    order, the pairs of one wave in any order, equals gather-then-scatter.
    With ``same_pool=False`` sources and destinations lie in different
    pools and only a repeated destination can clash.  Raises
    ``ValueError`` on a RAW or WAW pair.  A call without a write-after-read
    pair (the common case) is one wave, found without a Python loop."""
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    src, dst = p[:, 0], p[:, 1]
    n = len(p)
    uniq, first = np.unique(dst, return_index=True)
    if len(uniq) != n:
        i = np.setdiff1d(np.arange(n), first)[0]
        raise ValueError(f"pair {tuple(p[i])} rewrites a block an earlier "
                         "pair writes (WAW)")
    waves = np.zeros(n, np.int64)
    if not same_pool or not n:
        return waves
    # RAW: a source that an earlier pair writes (destinations are unique)
    pos = np.searchsorted(uniq, src).clip(max=n - 1)
    writer = np.where(uniq[pos] == src, first[pos], n)
    raw = np.flatnonzero(writer < np.arange(n))
    if len(raw):
        raise ValueError(f"pair {tuple(p[raw[0]])} reads a block an "
                         "earlier pair writes (RAW)")
    # without RAW, a destination another pair reads is a WAR writer, and
    # every reader of it comes earlier: iterate the waves to the fixpoint
    # (as many rounds as the longest writer-after-reader chain)
    reads = src != dst
    read = np.sort(src[reads])
    if not len(read):
        return waves
    war = read[np.searchsorted(read, dst).clip(max=len(read) - 1)] == dst
    if not war.any():
        return waves
    keys, inv = np.unique(p.reshape(-1), return_inverse=True)
    s_key, d_key = inv.reshape(-1, 2).T
    while True:
        latest = np.full(len(keys), -1, np.int64)
        np.maximum.at(latest, s_key[reads], waves[reads])
        new = np.where(war, latest[d_key] + 1, 0)
        if np.array_equal(new, waves):
            return waves
        waves = new


def host_ids(ids, width: int) -> np.ndarray:
    """Block ids (numpy, list or tensor) as an ``(m, width)`` int64 array
    on the host: the wrappers schedule rows there."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, np.int64).reshape(-1, width)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_move(entry: str, dst_pool: torch.Tensor, src_pool: torch.Tensor,
               rows: np.ndarray, waves: np.ndarray, *,
               block_axis: int) -> None:
    """Launch ``entry`` (``rc_fpm_copy`` or ``rc_zero_init``) once over the
    live ``(n, 2)`` ``[src, dst]`` rows, in wave order."""
    layers, page_bytes, word = block_geometry((dst_pool, src_pool),
                                              block_axis)
    order = np.argsort(waves, kind="stable")
    n_waves = int(waves.max()) + 1
    chunk = min(CHUNK_BYTES, page_bytes)
    cpp = -(-page_bytes // chunk)
    counts = np.bincount(waves, minlength=n_waves)
    prefix = np.concatenate([[0], np.cumsum(counts) * layers * cpp])
    header = [dst_pool.data_ptr(), src_pool.data_ptr(),
              int(dst_pool.shape[block_axis]),
              int(src_pool.shape[block_axis]), layers, page_bytes,
              len(rows), chunk, cpp, n_waves, word]
    desc_np = np.concatenate([np.asarray(header, np.int64),
                              rows[order].reshape(-1), prefix,
                              np.zeros(2, np.int64)]).astype(np.int64)
    device = dst_pool.device
    desc = torch.from_numpy(desc_np).to(device)
    counters = desc.data_ptr() + 8 * (len(desc_np) - 2)
    n_items = int(prefix[-1])
    grid = max(1, min(n_items, _sm_count(device) * CTAS_PER_SM))
    lib = library("fpm_copy" if entry == "rc_fpm_copy" else "zero_init")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(desc.data_ptr(), counters, grid, stream_ptr(device)), entry)


def _live_pairs(ids, n_src: int, n_dst: int) -> np.ndarray:
    """Rows with a destination in range, ``(n, 2)``; sources clipped as
    the plain version clips them."""
    a = host_ids(ids, 2)
    a = a[(a[:, 1] >= 0) & (a[:, 1] < n_dst)]
    a[:, 0] = a[:, 0].clip(0, n_src - 1)
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
           "block_move", "fpm_copy_cuda",
           "fpm_copy_cross_cuda"]
