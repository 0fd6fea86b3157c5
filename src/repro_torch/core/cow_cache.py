"""Copy-on-write paged KV cache (port of ``repro/core/cow_cache.py``, one
device).

``fork()`` shares every block by refcount (zero bytes move); the first
append to a shared block allocates a destination in the SAME slab
(``alloc_near``) and copies through the engine — FPM.  Fresh blocks are
BuZ-lazy-zeroed (the ZI bit).  The metadata is host numpy, as in the
reference; :meth:`PagedCoWCache.device_tables` returns tensors on the
engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import OutOfBlocks, SubarrayAllocator
from repro_torch.core.rowclone import RowCloneEngine


@dataclasses.dataclass
class Sequence:
    seq_id: int
    length: int
    blocks: List[int]          # pool block ids, in order
    slab_home: int             # preferred slab ("subarray" affinity)


class PagedCoWCache:
    """Block-table manager with CoW fork over a RowCloneEngine."""

    def __init__(self, engine: RowCloneEngine, page: int,
                 max_blocks_per_seq: int, max_seqs: int):
        self.engine = engine
        self.alloc: SubarrayAllocator = engine.alloc
        self.page = page
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_seqs = max_seqs
        self.seqs: Dict[int, Sequence] = {}
        self._next_id = 0
        self._dirty = True
        self._table = np.full((max_seqs, max_blocks_per_seq), -1, np.int32)
        self._mask = np.zeros((self.alloc.num_blocks, max_seqs), np.int8)
        self._base = np.zeros(self.alloc.num_blocks, np.int32)
        self._slot_of: Dict[int, int] = {}      # seq_id -> table row
        self._free_slots: List[int] = list(range(max_seqs - 1, -1, -1))

    def _take_slot(self) -> int:
        if not self._free_slots:
            raise RuntimeError("no free sequence slots")
        return self._free_slots.pop()

    # ------------------------------------------------------------------
    def new_sequence(self, prompt_len: int = 0,
                     prefer_slab: Optional[int] = None) -> int:
        """Admit a sequence: reserve a batch slot, allocate its prompt
        blocks (in ``prefer_slab``, else slab ``id % num_slabs``, while it
        has room) and BuZ-lazy-zero them.  Returns the sequence id."""
        slot = self._take_slot()
        sid = self._next_id
        self._next_id += 1
        nblk = (prompt_len + self.page - 1) // self.page
        prefer = sid % self.alloc.num_slabs if prefer_slab is None \
            else prefer_slab
        blocks = self.alloc.alloc(nblk, prefer_slab=prefer, zeroed=False)
        if blocks:
            self.engine.meminit(blocks)
        self.seqs[sid] = Sequence(sid, prompt_len, blocks, prefer)
        self._slot_of[sid] = slot
        self._dirty = True
        return sid

    def fork(self, parent_id: int, n_children: int = 1,
             eager_copy: bool = False) -> List[int]:
        """CoW fork: children share every parent block (refcount bump —
        zero bytes move now).

        ``eager_copy=True`` clones every block instead (children that
        diverge at once): each destination is allocated in its source's
        slab (FPM placement) and the copies of all children drain as ONE
        launch at the end of the fork.  Out of blocks, a child's partial
        clone is freed and :class:`OutOfBlocks` raised (children created
        before it stand)."""
        parent = self.seqs[parent_id]
        out = []
        with self.engine.batch():
            for _ in range(n_children):
                slot = self._take_slot()
                sid = self._next_id
                self._next_id += 1
                if eager_copy and parent.blocks:
                    blocks = []
                    try:
                        for b in parent.blocks:
                            blocks.append(self.alloc.alloc_near(b))
                    except OutOfBlocks:
                        self.alloc.free(blocks)
                        self._free_slots.append(slot)
                        raise
                    self.engine.memcopy(list(zip(parent.blocks, blocks)))
                else:
                    self.alloc.share(parent.blocks)
                    blocks = list(parent.blocks)
                self.seqs[sid] = Sequence(sid, parent.length, blocks,
                                          parent.slab_home)
                self._slot_of[sid] = slot
                out.append(sid)
        self._dirty = True
        return out

    def append_token(self, seq_id: int) -> Tuple[int, int]:
        """Reserve the slot for one new token; CoW-splits a shared block or
        allocates a tail block as needed.  Returns (block_id, offset)."""
        seq = self.seqs[seq_id]
        pos = seq.length
        j = pos // self.page
        off = pos % self.page
        if j >= self.max_blocks_per_seq:
            raise ValueError("sequence exceeds max_blocks_per_seq")
        if j >= len(seq.blocks):
            nb = self.alloc.alloc(1, prefer_slab=seq.slab_home,
                                  zeroed=False)[0]
            self.engine.meminit([nb])
            seq.blocks.append(nb)
            self._dirty = True
        else:
            b = seq.blocks[j]
            if self.alloc.is_shared(b):
                nb = self.alloc.alloc_near(b)
                self.engine.memcopy([(b, nb)])
                self.alloc.free([b])
                seq.blocks[j] = nb
                self._dirty = True
        seq.length = pos + 1
        return seq.blocks[j], off

    def append_tokens(self, seq_ids: List[int]) -> List[Tuple[int, int]]:
        """One decode step for a batch: every CoW split and tail init
        enqueues, and the device sees ONE fused launch at the flush."""
        with self.engine.batch():
            return [self.append_token(sid) for sid in seq_ids]

    def remap_blocks(self, seq_id: int, blocks: List[int]) -> None:
        """Replace a sequence's block list with caller-held blocks (the
        cache takes over their refcounts) and release the OLD list,
        refcount-aware; positions whose id is unchanged keep their ref.
        The length must match (relocation, not truncation)."""
        seq = self.seqs[seq_id]
        blocks = [int(b) for b in blocks]
        if len(blocks) != len(seq.blocks):
            raise ValueError(
                f"remap_blocks: {len(blocks)} blocks for a sequence "
                f"holding {len(seq.blocks)} (relocation must preserve "
                "the block count)")
        stale = [old for old, new in zip(seq.blocks, blocks) if old != new]
        if stale:
            self.alloc.free(stale)
        seq.blocks = blocks
        self._dirty = True

    def free_sequence(self, seq_id: int) -> None:
        """Release a sequence's blocks (refcount-aware) and its slot."""
        seq = self.seqs.pop(seq_id)
        self.alloc.free(seq.blocks)
        self._free_slots.append(self._slot_of.pop(seq_id))
        self._dirty = True

    # ------------------------------------------------------------------
    def rebuild_tables(self) -> None:
        """Recompute the block table, share mask and base offsets.  A
        CoW-shared block sets several share-mask columns."""
        self._table.fill(-1)
        self._mask.fill(0)
        self._base.fill(0)
        for sid, seq in self.seqs.items():
            slot = self._slot_of[sid]
            for j, b in enumerate(seq.blocks):
                self._table[slot, j] = b
                self._mask[b, slot] = 1
                self._base[b] = j * self.page
        self._dirty = False

    def host_tables(self):
        """(block_table (B, nper), share_mask (nblk, B), base (nblk,)) as
        numpy arrays."""
        if self._dirty:
            self.rebuild_tables()
        return self._table, self._mask, self._base

    def device_tables(self):
        """:meth:`host_tables` as tensors on the engine's device."""
        dev = self.engine.device
        return tuple(torch.from_numpy(a.copy()).to(dev)
                     for a in self.host_tables())

    def seq_lens(self) -> np.ndarray:
        """(max_seqs,) int32 sequence lengths, indexed by batch slot."""
        lens = np.zeros(self.max_seqs, np.int32)
        for sid, seq in self.seqs.items():
            lens[self._slot_of[sid]] = seq.length
        return lens

    def slot_of(self, seq_id: int) -> int:
        """The sequence's batch-table row."""
        return self._slot_of[seq_id]

    def blocks_of(self, seq_id: int) -> List[int]:
        """The sequence's pool block ids, in sequence order."""
        return list(self.seqs[seq_id].blocks)


__all__ = ["Sequence", "PagedCoWCache"]
