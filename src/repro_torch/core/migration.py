"""PSM migration planner — RowClone's page-migration application (§3.2),
port of ``repro/core/migration.py``.

Plans block moves between slabs for load balancing, elastic scaling or
defragmentation, batched by (src_slab, dst_slab) pair and issued in
chunks through the engine's ``memcopy``, which tags cross-slab pairs as
PSM copies.  Those go through K7, the PSM transfer (kernels/psm_transfer.py):
on a one-device engine as K7 with one rank and hop 0 in the fan-out (or
as rows of K1's fused drain), and on an engine over a rank mesh as K7's
hops between the ranks' slabs, in the sharded drain and in its fan-out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cow_cache import PagedCoWCache


@dataclasses.dataclass
class MigrationPlan:
    moves: List[Tuple[int, int]]            # (src_block, dst_block)
    pair_batches: Dict[Tuple[int, int], List[Tuple[int, int]]]
    seq_updates: Dict[int, Dict[int, int]]  # seq_id -> {old_block: new_block}


def plan_rebalance(cache: PagedCoWCache,
                   target_load: Optional[np.ndarray] = None
                   ) -> MigrationPlan:
    """Move blocks from overloaded slabs to underloaded ones.

    Load = allocated blocks per slab.  Only WHOLE sequences homed on an
    overloaded slab move (smallest first, none with a CoW-shared block),
    each to the least-loaded slab with room, so the FPM locality
    invariant holds after the migration."""
    alloc = cache.alloc
    used = np.zeros(alloc.num_slabs, np.int64)
    for seq in cache.seqs.values():
        for b in seq.blocks:
            used[alloc.slab_of(b)] += 1
    if target_load is None:
        target_load = np.full(alloc.num_slabs, used.mean())

    overloaded = [s for s in range(alloc.num_slabs)
                  if used[s] > target_load[s] + 1]

    moves: List[Tuple[int, int]] = []
    seq_updates: Dict[int, Dict[int, int]] = {}
    for s_over in overloaded:
        victims = sorted((q for q in cache.seqs.values()
                          if q.slab_home == s_over and
                          not any(alloc.is_shared(b) for b in q.blocks)),
                         key=lambda q: len(q.blocks))
        for seq in victims:
            if used[s_over] <= target_load[s_over] + 1:
                break
            need = len(seq.blocks)
            candidates = [s for s in range(alloc.num_slabs)
                          if s != s_over and used[s] + need <=
                          target_load[s] + 1 and
                          alloc.free_in_slab(s) >= need]
            if not candidates:
                break
            dst = min(candidates, key=lambda s: used[s])
            new_blocks = alloc.alloc(need, prefer_slab=dst)
            upd = {}
            for old, new in zip(seq.blocks, new_blocks):
                moves.append((old, new))
                upd[old] = new
            seq_updates[seq.seq_id] = upd
            used[s_over] -= need
            used[dst] += need

    batches: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for s, d in moves:
        key = (alloc.slab_of(s), alloc.slab_of(d))
        batches.setdefault(key, []).append((s, d))
    return MigrationPlan(moves, batches, seq_updates)


def execute(plan: MigrationPlan, cache: PagedCoWCache,
            chunk_blocks: int = 8) -> Dict[str, int]:
    """Issue the plan through the engine in chunks of ``chunk_blocks``,
    then commit the table updates and free the old blocks.  The commit is
    one metadata flip per sequence: readers never see a half-migrated
    sequence."""
    eng = cache.engine
    alloc = cache.alloc
    issued = 0
    for pairs in plan.pair_batches.values():
        for i in range(0, len(pairs), chunk_blocks):
            eng.memcopy(pairs[i: i + chunk_blocks])
            issued += len(pairs[i: i + chunk_blocks])
    for sid, upd in plan.seq_updates.items():
        seq = cache.seqs[sid]
        seq.blocks = [upd.get(b, b) for b in seq.blocks]
        alloc.free(list(upd.keys()))
        seq.slab_home = alloc.slab_of(seq.blocks[0]) if seq.blocks \
            else seq.slab_home
    cache._dirty = True
    return {"moved_blocks": issued, "psm": eng.stats.psm_copies}


__all__ = ["MigrationPlan", "plan_rebalance", "execute"]
