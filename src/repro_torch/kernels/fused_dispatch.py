"""K1 — the fused command-table drain: launch accounting, drain guards, the
host wave schedule and the CUDA wrapper.

Replaces the TPU kernel ``_make_kernel`` of
``repro/kernels/fused_dispatch.py`` (``fused_dispatch_pallas``, the
``pallas_call`` at :406).  The kernel is ``csrc/fused_dispatch.cu``; its
plain version is :func:`repro_torch.kernels.ref.fused_dispatch`.

Bound on the card: bytes (each row reads and writes one page per layer of
every pool it touches; bound = bytes / 3.35 TB/s).  The kernel streams raw
bytes with 16-byte vectors whatever the dtype.  Rows run concurrently on the
GPU, so the host orders them: :func:`wave_schedule` puts every
write-after-read writer in a later wave than every earlier reader of its
block, and the kernel starts a wave's work only after the earlier waves are
done, all inside ONE launch.  A table with a RAW or WAW pair breaks the
contract (the command queue never flushes one) and raises here rather than
drain differently from the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opcodes import keys_clash, row_rw
from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr
from repro_torch.kernels.ref import address_space, as_primary

#: launches of the CUDA drain kernel (not of its plain version)
COUNTER = LaunchCounter("fused_dispatch")

#: bytes of one page a CTA moves per work item
CHUNK_BYTES = 32 * 1024
#: resident CTAs per SM the drain's grid is sized for
CTAS_PER_SM = 8

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
# the CUDA wrapper
# ---------------------------------------------------------------------------

def block_geometry(pools: Sequence[torch.Tensor], block_axis: int
                   ) -> Tuple[int, int, int]:
    """(layers, page_bytes, word_bytes) of pools that share one device,
    dtype and block shape; raises on what the kernels do not take.
    ``word_bytes`` is the widest access (16, 8, ... 1 bytes) that divides
    the page size and every pool's base address."""
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


def fused_dispatch_cuda(pools: Sequence[torch.Tensor], cmds, *,
                        block_axis: int,
                        primary: Optional[Sequence[bool]] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Drain one command table over CUDA pools, in place, with ONE launch
    of the kernel (none for a table without live rows).  Zero-init rows
    store zero bytes: the reserved zero block is all zeros by
    construction."""
    pools = tuple(pools)
    primary = as_primary(primary, len(pools))
    layers, page_bytes, word = block_geometry(pools, block_axis)
    if word != 16:
        raise ValueError(f"fused drain: pages of {page_bytes} bytes are not "
                         "16-byte aligned")
    sizes = [int(p.shape[block_axis]) for p in pools]
    bases, total, _ = address_space(sizes)
    if isinstance(cmds, torch.Tensor):
        cmds = cmds.cpu().numpy()
    live = [(op, s, d) for op, s, d in np.asarray(cmds, np.int64).tolist()
            if op >= 0 and d >= 0]
    if not live:
        return pools
    waves = wave_schedule(live, sizes, primary)
    order = sorted(range(len(live)), key=lambda i: (waves[i], i))
    n_waves = max(waves) + 1
    chunk = min(CHUNK_BYTES, page_bytes)
    cpp = -(-page_bytes // chunk)
    per_row = layers * cpp
    counts = np.bincount(np.asarray(waves), minlength=n_waves)
    prefix = np.concatenate([[0], np.cumsum(counts) * per_row])
    header = [len(pools), layers, page_bytes, len(live), chunk, cpp,
              n_waves, total]
    recs = [v for i, p in enumerate(pools)
            for v in (p.data_ptr(), sizes[i], bases[i], int(primary[i]))]
    rows = [v for i in order for v in live[i]]
    desc_np = np.asarray(header + recs + rows + prefix.tolist() + [0, 0],
                         np.int64)
    device = pools[0].device
    desc = torch.from_numpy(desc_np).to(device)
    counters = desc.data_ptr() + 8 * (len(desc_np) - 2)
    n_items = int(prefix[-1])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = max(1, min(n_items, sms * CTAS_PER_SM))
    lib = library("fused_dispatch")
    fn = lib.rc_fused_drain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(desc.data_ptr(), counters, grid, stream_ptr(device)),
          "fused drain kernel")
    COUNTER.n += 1
    return pools


__all__ = ["COUNTER", "DrainInfo", "add_drain_guard", "remove_drain_guard",
           "check_drain", "add_launch_hook", "remove_launch_hook",
           "launch_count", "notify_launch", "wave_schedule",
           "block_geometry", "fused_dispatch_cuda"]
