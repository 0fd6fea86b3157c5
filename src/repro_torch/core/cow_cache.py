"""Copy-on-write paged KV cache (port of ``repro/core/cow_cache.py``).

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
    group: int = 0             # batch group owning the sequence's slot


class PagedCoWCache:
    """Block-table manager with CoW fork over a RowCloneEngine.

    ``batch_groups`` > 1 gives the sharded-batch tables: the decode batch
    shards over a mesh's (pod, data) axes into that many groups, the share
    mask has LOCAL columns (``max_seqs // batch_groups``; column = slot %
    local batch), and every sequence's blocks are pinned inside its
    group's slabs (the allocator's ``allowed_slabs``), so each group of
    ranks serves its own sequences from its own slabs.  ``batch_groups=1``
    keeps global columns and unconstrained placement."""

    def __init__(self, engine: RowCloneEngine, page: int,
                 max_blocks_per_seq: int, max_seqs: int,
                 batch_groups: int = 1):
        self.engine = engine
        self.alloc: SubarrayAllocator = engine.alloc
        self.page = page
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_seqs = max_seqs
        if batch_groups > 1 and (max_seqs % batch_groups
                                 or self.alloc.num_blocks % batch_groups
                                 or self.alloc.num_slabs % batch_groups):
            raise ValueError(
                f"batch_groups={batch_groups} must divide max_seqs="
                f"{max_seqs}, nblk={self.alloc.num_blocks} and "
                f"num_slabs={self.alloc.num_slabs}")
        self.batch_groups = batch_groups
        self.b_local = max_seqs // batch_groups
        self.seqs: Dict[int, Sequence] = {}
        self._next_id = 0
        self._dirty = True
        self._table = np.full((max_seqs, max_blocks_per_seq), -1, np.int32)
        self._mask = np.zeros((self.alloc.num_blocks, self.b_local), np.int8)
        self._base = np.zeros(self.alloc.num_blocks, np.int32)
        self._slot_of: Dict[int, int] = {}      # seq_id -> table row
        # per-group slot free lists (one group when unsharded)
        self._free_slots: List[List[int]] = [
            list(range((g + 1) * self.b_local - 1, g * self.b_local - 1, -1))
            for g in range(batch_groups)]

    # ------------------------------------------------------------------
    # group arithmetic (no-ops when batch_groups == 1)
    # ------------------------------------------------------------------
    def group_of_block(self, block_id: int) -> int:
        """Batch group owning the slabs that hold ``block_id``."""
        return block_id // (self.alloc.num_blocks // self.batch_groups)

    def group_slabs(self, group: int) -> Optional[List[int]]:
        """Allocator slabs inside ``group``'s block range (None = any)."""
        if self.batch_groups == 1:
            return None
        spg = self.alloc.num_slabs // self.batch_groups
        return list(range(group * spg, (group + 1) * spg))

    def _pick_group(self) -> int:
        """Group with a free slot and the most headroom (free slots, then
        free blocks)."""
        best, best_key = -1, None
        for g in range(self.batch_groups):
            if not self._free_slots[g]:
                continue
            free_blocks = sum(self.alloc.free_in_slab(s)
                              for s in (self.group_slabs(g) or
                                        range(self.alloc.num_slabs)))
            key = (len(self._free_slots[g]), free_blocks)
            if best_key is None or key > best_key:
                best, best_key = g, key
        if best < 0:
            raise RuntimeError("no free sequence slots")
        return best

    # ------------------------------------------------------------------
    def new_sequence(self, prompt_len: int = 0,
                     prefer_slab: Optional[int] = None) -> int:
        """Admit a sequence: reserve a batch slot, allocate its prompt
        blocks (in ``prefer_slab``, else slab ``id % slabs``, while it has
        room; inside the slot's group slabs when the batch shards) and
        BuZ-lazy-zero them.  Returns the sequence id."""
        sid = self._next_id
        self._next_id += 1
        nblk = (prompt_len + self.page - 1) // self.page
        group = self._pick_group()
        slabs = self.group_slabs(group)
        if prefer_slab is None or (slabs is not None
                                   and prefer_slab not in slabs):
            pool = slabs or list(range(self.alloc.num_slabs))
            prefer_slab = pool[sid % len(pool)]
        blocks = self.alloc.alloc(nblk, prefer_slab=prefer_slab,
                                  zeroed=False, allowed_slabs=slabs)
        if blocks:
            self.engine.meminit(blocks)
        self.seqs[sid] = Sequence(sid, prompt_len, blocks, prefer_slab,
                                  group)
        self._slot_of[sid] = self._free_slots[group].pop()
        self._dirty = True
        return sid

    def fork(self, parent_id: int, n_children: int = 1,
             eager_copy: bool = False) -> List[int]:
        """CoW fork: children share every parent block (refcount bump —
        zero bytes move now).

        ``eager_copy=True`` clones every block instead (children that
        diverge at once): each destination is allocated in its source's
        slab (FPM placement) and the copies of all children drain as ONE
        launch at the end of the fork.  A share is visible only inside
        the block's batch group, so a child that lands in another group
        (the parent's has no free slot) is always eager-copied across.
        Out of blocks, a child's partial clone is freed and
        :class:`OutOfBlocks` raised (children created before it stand)."""
        parent = self.seqs[parent_id]
        out = []
        with self.engine.batch():
            for _ in range(n_children):
                sid = self._next_id
                self._next_id += 1
                if self._free_slots[parent.group]:
                    group, eager = parent.group, eager_copy
                else:
                    group, eager = self._pick_group(), True
                slabs = self.group_slabs(group)
                if eager and parent.blocks:
                    blocks = []
                    try:
                        for b in parent.blocks:
                            blocks.append(self.alloc.alloc_near(
                                b, allowed_slabs=slabs))
                    except OutOfBlocks:
                        self.alloc.free(blocks)
                        raise
                    self.engine.memcopy(list(zip(parent.blocks, blocks)))
                else:
                    self.alloc.share(parent.blocks)
                    blocks = list(parent.blocks)
                home = parent.slab_home if slabs is None or \
                    parent.slab_home in slabs else slabs[0]
                self.seqs[sid] = Sequence(sid, parent.length, blocks, home,
                                          group)
                self._slot_of[sid] = self._free_slots[group].pop()
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
                                  zeroed=False,
                                  allowed_slabs=self.group_slabs(seq.group)
                                  )[0]
            self.engine.meminit([nb])
            seq.blocks.append(nb)
            self._dirty = True
        else:
            b = seq.blocks[j]
            if self.alloc.is_shared(b):
                nb = self.alloc.alloc_near(
                    b, allowed_slabs=self.group_slabs(seq.group))
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
        The length must match (relocation, not truncation), and under
        sharded batches every new block must lie in the sequence's
        group."""
        seq = self.seqs[seq_id]
        blocks = [int(b) for b in blocks]
        if len(blocks) != len(seq.blocks):
            raise ValueError(
                f"remap_blocks: {len(blocks)} blocks for a sequence "
                f"holding {len(seq.blocks)} (relocation must preserve "
                "the block count)")
        if self.batch_groups > 1:
            for b in blocks:
                if self.group_of_block(b) != seq.group:
                    raise ValueError(
                        f"remap_blocks: block {b} lives in group "
                        f"{self.group_of_block(b)}, sequence {seq_id} "
                        f"is pinned to group {seq.group}")
        stale = [old for old, new in zip(seq.blocks, blocks) if old != new]
        if stale:
            self.alloc.free(stale)
        seq.blocks = blocks
        self._dirty = True

    def free_sequence(self, seq_id: int) -> None:
        """Release a sequence's blocks (refcount-aware) and its slot."""
        seq = self.seqs.pop(seq_id)
        self.alloc.free(seq.blocks)
        self._free_slots[seq.group].append(self._slot_of.pop(seq_id))
        self._dirty = True

    # ------------------------------------------------------------------
    def rebuild_tables(self) -> None:
        """Recompute the block table, share mask and base offsets.  A
        CoW-shared block sets several share-mask columns.  With
        ``batch_groups > 1`` the columns are LOCAL (slot % b_local), valid
        because every block of a sequence lies in its group (asserted: a
        violation would attach the block to another group's sequence)."""
        self._table.fill(-1)
        self._mask.fill(0)
        self._base.fill(0)
        for sid, seq in self.seqs.items():
            slot = self._slot_of[sid]
            for j, b in enumerate(seq.blocks):
                self._table[slot, j] = b
                if self.batch_groups > 1:
                    assert self.group_of_block(b) == seq.group, \
                        (b, self.group_of_block(b), seq.group, sid)
                self._mask[b, slot % self.b_local] = 1
                self._base[b] = j * self.page
        self._dirty = False

    def host_tables(self):
        """(block_table (B, nper), share_mask (nblk, B // batch_groups),
        base (nblk,)) as numpy arrays."""
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
        """The sequence's batch-table row (slot // b_local = its group)."""
        return self._slot_of[seq_id]

    def blocks_of(self, seq_id: int) -> List[int]:
        """The sequence's pool block ids, in sequence order."""
        return list(self.seqs[seq_id].blocks)


__all__ = ["Sequence", "PagedCoWCache"]
