"""Subarray-aware block allocator of the PyTorch port (host metadata).

A copy of ``repro/core/allocator.py``: a free list per slab ("subarray"),
reference counts for CoW sharing, the lazy-zero (ZI) bit and one reserved
zero row per slab (paper §3.1).  numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the allowed
    slabs (the pool — or a batch group's slab subset — is exhausted)."""


@dataclasses.dataclass
class AllocStats:
    allocs: int = 0
    frees: int = 0
    cow_shares: int = 0
    fpm_eligible: int = 0      # destination landed in the source's slab
    psm_fallback: int = 0      # had to place cross-slab
    lazy_zero: int = 0         # zero requests satisfied by metadata only
    materialized_zero: int = 0


class SubarrayAllocator:
    """Free-list allocator over ``num_blocks`` partitioned into ``num_slabs``
    equal slabs (= device shards of the pool's block axis)."""

    def __init__(self, num_blocks: int, num_slabs: int,
                 reserved_zero_per_slab: int = 1):
        assert num_blocks % num_slabs == 0
        self.num_blocks = num_blocks
        self.num_slabs = num_slabs
        self.slab_size = num_blocks // num_slabs
        self.refcount = np.zeros(num_blocks, np.int32)
        self.is_zero = np.zeros(num_blocks, bool)   # ZI lazy-zero bit
        self.stats = AllocStats()
        self._free: List[List[int]] = []
        self.zero_rows: List[int] = []              # reserved per-slab rows
        for s in range(num_slabs):
            lo, hi = s * self.slab_size, (s + 1) * self.slab_size
            rows = list(range(lo, hi))
            reserved = rows[:reserved_zero_per_slab]
            self.zero_rows.extend(reserved)
            self.refcount[reserved] = 1             # pinned forever
            self.is_zero[reserved] = True
            self._free.append(rows[reserved_zero_per_slab:])

    # ------------------------------------------------------------------
    def slab_of(self, block_id: int) -> int:
        """Slab ("subarray") index holding ``block_id``."""
        return block_id // self.slab_size

    def free_in_slab(self, slab: int) -> int:
        """Free blocks remaining in one slab."""
        return len(self._free[slab])

    def total_free(self) -> int:
        """Free blocks remaining across every slab."""
        return sum(len(f) for f in self._free)

    # ------------------------------------------------------------------
    def alloc(self, n: int = 1, prefer_slab: Optional[int] = None,
              zeroed: bool = False,
              allowed_slabs: Optional[Sequence[int]] = None) -> List[int]:
        """Allocate ``n`` blocks, preferring ``prefer_slab`` (subarray-aware
        placement).  Falls back to the least-loaded slab.

        ``allowed_slabs`` restricts the fallback set — the sharded-batch
        serving tables use it to pin a sequence's blocks inside the device
        group that owns the sequence's batch slot, so share-mask columns
        can use local numbering.  Raises :class:`OutOfBlocks` when the
        allowed slabs are exhausted rather than silently crossing the
        group boundary."""
        out: List[int] = []
        pool = (list(allowed_slabs) if allowed_slabs is not None
                else list(range(self.num_slabs)))
        for _ in range(n):
            slab = prefer_slab
            if slab is None or slab not in pool or not self._free[slab]:
                if prefer_slab is not None:
                    self.stats.psm_fallback += 1
                slab = pool[int(np.argmax([len(self._free[s])
                                           for s in pool]))]
                if not self._free[slab]:
                    # roll back this request's partial grab: group
                    # exhaustion is a routine, recoverable event for the
                    # sharded-batch serving tables, and leaked blocks
                    # would permanently shrink the group
                    self.free(out)
                    self.stats.allocs -= len(out)
                    self.stats.frees -= len(out)
                    raise OutOfBlocks(
                        f"pool exhausted ({self.num_blocks} blocks, "
                        f"slabs {pool})")
            elif prefer_slab is not None:
                self.stats.fpm_eligible += 1
            bid = self._free[slab].pop()
            self.refcount[bid] = 1
            self.is_zero[bid] = bool(zeroed)
            out.append(bid)
            self.stats.allocs += 1
        return out

    def alloc_near(self, src_block: int, zeroed: bool = False,
                   allowed_slabs: Optional[Sequence[int]] = None) -> int:
        """CoW destination placement: same slab as the source when possible
        (paper §3.1 — enables FPM for the copy)."""
        return self.alloc(1, prefer_slab=self.slab_of(src_block),
                          zeroed=zeroed, allowed_slabs=allowed_slabs)[0]

    def share(self, ids: Sequence[int]) -> None:
        """CoW share (fork): bump refcounts — the ZI 'in-cache copy': no
        bytes move."""
        for b in ids:
            assert self.refcount[b] > 0, f"share of unallocated block {b}"
            self.refcount[b] += 1
            self.stats.cow_shares += 1

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; blocks return to their slab's free
        list when the last sharer releases them."""
        for b in ids:
            assert self.refcount[b] > 0, f"double free of block {b}"
            self.refcount[b] -= 1
            self.stats.frees += 1
            if self.refcount[b] == 0:
                self._free[self.slab_of(b)].append(int(b))

    def is_shared(self, block_id: int) -> bool:
        """More than one sequence references the block (CoW pending)."""
        return self.refcount[block_id] > 1

    # ------------------------------------------------------------------
    def mark_zero(self, ids: Sequence[int]) -> None:
        """Set the ZI lazy-zero bit: the blocks are LOGICALLY zero in
        every primary pool while physically holding stale bytes."""
        self.is_zero[list(ids)] = True
        self.stats.lazy_zero += len(ids)

    def mark_written(self, ids: Sequence[int]) -> None:
        """Clear the lazy-zero bit: the blocks now hold real data."""
        self.is_zero[list(ids)] = False

    def pending_zero(self, ids: Sequence[int]) -> List[int]:
        """Blocks that must be physically zeroed before a non-masking
        consumer touches them."""
        return [int(b) for b in ids if self.is_zero[b]]

    def zero_row_of(self, slab: int) -> int:
        """The slab's reserved all-zero row (the BuZ broadcast source)."""
        return self.zero_rows[slab]
