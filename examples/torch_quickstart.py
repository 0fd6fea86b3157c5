"""Quickstart of the PyTorch port: the RowClone engine in five minutes.

The counterpart of ``examples/quickstart.py``: builds a bf16 block pool
on the device, exercises memcopy/meminit dispatch (FPM / PSM / ZI),
forks a sequence CoW-style, migrates sequences between slabs by PSM, and
prints the stats the paper's Table 1 is made of.  On the card every
flush drains through the fused command-table kernel.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (BlockRef, PagedCoWCache, RowCloneEngine,
                              SubarrayAllocator)
from repro_torch.core.migration import (execute as migrate_execute,
                                        plan_rebalance)
from repro_torch.weights import resolve_device


def main(argv=None) -> RowCloneEngine:
    """Run the five sections on ``--device`` (default the card; without a
    GPU pass ``--device cpu``); returns the engine, whose pools and stats
    the run left."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    page, kvh, hd = 16, 2, 64
    nblk, nslabs = 64, 4

    print("=== 1. pools + subarray-aware allocator ===")
    alloc = SubarrayAllocator(nblk, nslabs, reserved_zero_per_slab=1)
    pools = {name: torch.zeros((nblk, page, kvh, hd), dtype=torch.bfloat16,
                               device=device) for name in ("k", "v")}
    engine = RowCloneEngine(pools, alloc, max_requests=16)
    print(f"pool: {nblk} blocks x {page}tok, {nslabs} slabs "
          f"(reserved zero rows: {alloc.zero_rows})")
    # the engine's address space: per-pool block counts + base offsets
    print("address space: " + "  ".join(
        f"{s.name}[nblk={s.nblk} base={engine.group.base(s.name)}]"
        for s in engine.group))

    print("\n=== 2. memcopy dispatch: FPM vs PSM (BlockRef addressing) ===")
    src = alloc.alloc(2, prefer_slab=0)
    alloc.mark_written(src)
    # an out-of-band write of one block, in place
    engine.pools["k"][src[0]] = 1.0
    engine.mark_pools_written(["k"])
    dst_near = alloc.alloc_near(src[0])        # same slab -> FPM
    dst_far = alloc.alloc(1, prefer_slab=3)[0]  # cross slab -> PSM
    counts = engine.memcopy([
        (BlockRef("k", src[0]), BlockRef("k", dst_near)),
        (BlockRef("k", src[1]), BlockRef("k", dst_far)),
    ])   # a plain copy moves the block in EVERY primary pool (k AND v)
    print(f"dispatch: {counts}  (bytes: fpm={engine.stats.bytes_fpm} "
          f"psm={engine.stats.bytes_psm})")

    print("\n=== 3. meminit: BuZ + ZI lazy zero ===")
    fresh = alloc.alloc(4, prefer_slab=1)
    engine.meminit([BlockRef("k", b) for b in fresh])     # metadata only
    print(f"lazy-zeroed {len(fresh)} blocks; bytes avoided so far: "
          f"{engine.stats.bytes_avoided}")
    engine.materialize_zeros(fresh[:1])        # zero-row copy when required
    print("materialized 1 block via the reserved zero row")

    print("\n=== 4. CoW fork (the paper's killer app) ===")
    cache = PagedCoWCache(engine, page, max_blocks_per_seq=8, max_seqs=8)
    sid = cache.new_sequence(prompt_len=3 * page // 2)   # 1.5 blocks
    alloc.mark_written(cache.blocks_of(sid))
    kids = cache.fork(sid, 3)
    print(f"forked seq {sid} -> {kids}: cow_shares={alloc.stats.cow_shares}, "
          f"bytes moved by fork: 0")
    blk, off = cache.append_token(kids[0])     # divergence -> CoW split
    print(f"child {kids[0]} appended at block {blk} slot {off}: "
          f"fpm_copies={engine.stats.fpm_copies} "
          f"(same-slab dst: {alloc.stats.fpm_eligible > 0})")

    print("\n=== 5. PSM migration (page-migration application) ===")
    for _ in range(2):
        s = cache.new_sequence(prompt_len=2 * page, prefer_slab=0)
        alloc.mark_written(cache.blocks_of(s))
    plan = plan_rebalance(cache)
    stats = migrate_execute(plan, cache)
    print(f"rebalanced: {stats}")

    print("\n=== engine stats ===")
    for k, v in vars(engine.stats).items():
        print(f"  {k:20s} {v}")
    return engine


if __name__ == "__main__":
    main()
