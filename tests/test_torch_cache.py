"""The port's PagedCoWCache against the JAX package's: the same admit /
fork / append / free scripts give identical block tables, share masks,
bases, sequence lengths and allocator state, and the CoW splits drain the
same rows."""
import random

import numpy as np
import pytest

from test_dispatch_properties import mk_engine
from test_torch_contract import (assert_same_pools, journal_rows,
                                 port_engine_like)

from repro.core import PagedCoWCache as JCache
from repro_torch.core.cow_cache import PagedCoWCache as TCache

PAGE, MAX_BLOCKS, MAX_SEQS = 4, 8, 6


def _pair():
    jeng = mk_engine(64, 1, use_fused=True, stage_nblk=8, seed=5)
    teng = port_engine_like(jeng)
    return (JCache(jeng, PAGE, MAX_BLOCKS, MAX_SEQS),
            TCache(teng, PAGE, MAX_BLOCKS, MAX_SEQS))


def _same(jc, tc):
    jt = [np.asarray(a) for a in jc.device_tables()]
    tt = [a.numpy() for a in tc.device_tables()]
    for name, a, b in zip(("block_table", "share_mask", "base"), jt, tt):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(jc.seq_lens(), tc.seq_lens())
    assert sorted(jc.seqs) == sorted(tc.seqs)
    for sid in jc.seqs:
        assert jc.blocks_of(sid) == tc.blocks_of(sid)
        assert jc.slot_of(sid) == tc.slot_of(sid)
    np.testing.assert_array_equal(jc.alloc.refcount, tc.alloc.refcount)
    np.testing.assert_array_equal(jc.alloc.is_zero, tc.alloc.is_zero)


@pytest.mark.parametrize("seed", range(4))
def test_cache_scripts_match_reference(seed):
    rng = random.Random(seed)
    jc, tc = _pair()
    for _ in range(30):
        live = sorted(jc.seqs)
        verb = rng.choice(["admit", "admit", "fork", "append", "append",
                           "append", "free"])
        if verb == "admit" and len(live) < MAX_SEQS - 1:
            n = rng.randint(0, 3 * PAGE)
            assert jc.new_sequence(prompt_len=n) == \
                tc.new_sequence(prompt_len=n)
        elif verb == "fork" and live and len(live) < MAX_SEQS - 1:
            sid = rng.choice(live)
            assert jc.fork(sid, 1) == tc.fork(sid, 1)
        elif verb == "append" and live:
            ids = [s for s in live
                   if jc.seqs[s].length < PAGE * MAX_BLOCKS - 1]
            assert jc.append_tokens(ids) == tc.append_tokens(ids)
        elif verb == "free" and live:
            sid = rng.choice(live)
            jc.free_sequence(sid)
            tc.free_sequence(sid)
        _same(jc, tc)
    assert journal_rows(tc.engine) == journal_rows(jc.engine)
    assert_same_pools(jc.engine, tc.engine, f"(seed={seed})")


def test_fork_then_append_splits_once_per_sharer():
    """Fork shares by refcount (no rows); the first appends into the
    shared tail split it with FPM copies in the block's own slab, and the
    last sharer writes in place — on both packages alike."""
    jc, tc = _pair()
    for c in (jc, tc):
        sid = c.new_sequence(prompt_len=PAGE + 2)
        c.alloc.mark_written(c.blocks_of(sid))      # the prompt landed
        c.fork(sid, 2)
    _same(jc, tc)
    assert len(tc.engine.journal) == 0
    jc.append_tokens(sorted(jc.seqs))
    tc.append_tokens(sorted(tc.seqs))
    _same(jc, tc)
    assert tc.engine.stats.fpm_copies == jc.engine.stats.fpm_copies == 2
    assert journal_rows(tc.engine) == journal_rows(jc.engine)


@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("use_fused", [True, False])
def test_fork_eager_copy_matches_reference(use_fused, block_axis):
    """``fork(..., eager_copy=True)`` clones every parent block next to its
    source for each child, on both packages alike: the same tables,
    allocator state and journal rows, bitwise pools, and the copies of
    both children in ONE launch: the fused drain, or on the fan-out one
    K5a call per primary pool (k and v), as the reference's."""
    from repro.kernels import fused_dispatch as jfd
    from test_torch_contract import PortHook
    jeng = mk_engine(64, block_axis, use_fused=use_fused, stage_nblk=8,
                     seed=5)
    teng = port_engine_like(jeng)
    jc, tc = (JCache(jeng, PAGE, MAX_BLOCKS, MAX_SEQS),
              TCache(teng, PAGE, MAX_BLOCKS, MAX_SEQS))
    for c in (jc, tc):
        sid = c.new_sequence(prompt_len=2 * PAGE + 1)
        c.alloc.mark_written(c.blocks_of(sid))      # the prompt landed
        c.fork(sid, 1)                              # a CoW share first
    events_j = []
    hook = lambda n, p, m: events_j.append((n, p, m))  # noqa: E731
    jfd.add_launch_hook(hook)
    try:
        kids_j = jc.fork(sid, 2, eager_copy=True)
    finally:
        jfd.remove_launch_hook(hook)
    with PortHook() as events_t:
        kids_t = tc.fork(sid, 2, eager_copy=True)
    assert kids_t == kids_j
    assert events_t == events_j
    assert [m for _, _, m in events_t] == (["fused"] if use_fused else
                                          ["legacy_fpm"] * 2)
    _same(jc, tc)
    parent = tc.blocks_of(sid)
    for kid in kids_t:
        assert set(tc.blocks_of(kid)).isdisjoint(parent)
        assert [tc.alloc.slab_of(b) for b in tc.blocks_of(kid)] == \
            [tc.alloc.slab_of(b) for b in parent]
    assert tc.engine.stats.fpm_copies == jc.engine.stats.fpm_copies == 6
    assert journal_rows(tc.engine) == journal_rows(jc.engine)
    assert_same_pools(jc.engine, tc.engine, f"(fused={use_fused})")
