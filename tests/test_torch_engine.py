"""The port's RowCloneEngine against the JAX engine on the same op script:
memcopy (FPM, PSM, alias), meminit (lazy and materialised), cross-pool
copies, AND/OR/NOT, staging (``stage_blocks`` / ``promote_staged`` /
``retire_promotions``) and streams with ``capture()``.  Compared: the
journal rows, ``EngineStats``, launches per flush and the pools, bitwise.
A stale ``FlushTicket.block_state`` raises, as in the reference."""
import numpy as np
import pytest

from test_dispatch_properties import mk_engine
from test_torch_contract import (PortHook, assert_same_pools, common_stats,
                                 journal_rows, port_engine_like, queue_stats)

import repro.core.poolspec as jcore
import repro_torch.core.poolspec as tcore
from repro.kernels import fused_dispatch as jfd


def _script(eng, core):
    """One scripted session against either engine; returns the per-flush
    launch counts of every explicit flush, in order."""
    BR = core.BlockRef
    launches = []
    eng.alloc.mark_written(list(range(1, 32)))
    # eager calls: each flushes on return
    eng.memcopy([(1, 2), (3, 20)])                 # FPM + PSM (other slab)
    eng.meminit([4, 5])                            # lazy: metadata only
    eng.memcopy([(4, 6)])                          # alias of a lazy zero
    eng.meminit([7], lazy=False)                   # BuZ row
    eng.memcopy_cross([(BR("k", 8), BR("v", 9)),
                       (BR("v", 10), BR("k_stage", 1))])
    eng.memand([(11, 12, 13)])                     # primary fan-out
    eng.memor([(BR("k", 14), BR("k_stage", 2), BR("v", 15))])
    eng.memnot([(BR("v", 16), BR("v_stage", 3))])
    eng.memcopy_cross([(BR("k", 4), BR("v_stage", 0))])  # lazy source
    # batched: one flush with a WAR pair spaced apart
    with eng.batch():
        eng.memcopy([(17, 18), (19, 17)])
        eng.materialize_zeros([21])
    # staging: promotions on a stream, one retired before the flush
    s = eng.stream("serve")
    slots = eng.stage_blocks(3)
    s.promote_staged([(slot, 22 + i) for i, slot in enumerate(slots)])
    eng.retire_promotions([(slots[1], 23)])
    with s.capture():
        eng.memcopy([(24, 25)])
        eng.meminit([26], lazy=False)
    ticket = s.flush()
    launches.append(ticket.launches)
    launches.append(s.flush().launches)            # empty flush: 0
    # cross-stream guard: a second stream touching a pending block
    a, b = eng.stream("a"), eng.stream("b")
    a.memcopy([(27, 28)])
    b.memcopy([(28, 29)])                          # reads a's pending dst
    launches.append(b.flush().launches)
    launches.append(eng.stage_slots_free)
    return launches


def _jax_engine():
    return mk_engine(32, 1, use_fused=True, stage_nblk=8, seed=3)


def test_scripted_session_matches_reference():
    jeng = _jax_engine()
    teng = port_engine_like(jeng)
    events_j = []
    hook = lambda n, p, m: events_j.append((n, p, m))  # noqa: E731
    jfd.add_launch_hook(hook)
    try:
        got_j = _script(jeng, jcore)
    finally:
        jfd.remove_launch_hook(hook)
    with PortHook() as events_t:
        got_t = _script(teng, tcore)
    assert got_t == got_j
    assert events_t == events_j
    assert journal_rows(teng) == journal_rows(jeng)
    j_stats, t_stats = common_stats(jeng, teng)
    assert t_stats == j_stats
    assert queue_stats(teng.queue) == queue_stats(jeng.queue)
    np.testing.assert_array_equal(teng.alloc.is_zero, jeng.alloc.is_zero)
    np.testing.assert_array_equal(teng.alloc.refcount, jeng.alloc.refcount)
    assert_same_pools(jeng, teng, "(script)")


def test_flush_ticket_reads_and_expires():
    """A ticket reads post-drain block state until a later in-place write
    moves the pools on; then block_state raises (the reference raises once
    its donated buffers are gone).  Metadata never expires."""
    teng = port_engine_like(_jax_engine())
    teng.alloc.mark_written([1, 2, 3])
    s = teng.stream("t")
    s.memcopy([(1, 2)])
    t1 = s.flush()
    assert t1.moved and t1.commands == 1 and t1.touched == ("k", "v")
    assert t1.wait() is t1
    blk = t1.block_state(2)
    np.testing.assert_array_equal(blk["k"], teng.pools["k"][:, 1].numpy())
    np.testing.assert_array_equal(
        t1.block_state(tcore.BlockRef("v", 2)), teng.pools["v"][:, 1].numpy())
    assert not t1.expired
    s.memcopy([(3, 4)])
    s.flush()
    assert t1.expired
    with pytest.raises(RuntimeError, match="expired"):
        t1.block_state(2)
    with pytest.raises(RuntimeError, match="expired"):
        t1.block_state(tcore.BlockRef("k", 2))
    assert t1.launches == 1
    # the later flush wrote only the primary pools: the ticket's staging
    # blocks are still the state it describes
    t1.block_state(tcore.BlockRef("k_stage", 0))


def test_drain_guard_aborts_before_dispatch():
    """A drain guard that raises aborts the flush before the pools change
    (the journal keeps no record of an undispatched flush)."""
    from repro_torch.kernels import fused_dispatch as tfd
    teng = port_engine_like(_jax_engine())
    teng.alloc.mark_written([1])
    before = teng.pools["k"].clone()

    def guard(info):
        raise RuntimeError(f"refused flush {info.flush}")

    tfd.add_drain_guard(guard)
    try:
        with pytest.raises(RuntimeError, match="refused"):
            teng.memcopy([(1, 2)])
    finally:
        tfd.remove_drain_guard(guard)
    assert teng.stats.launches == 0 and len(teng.journal) == 0
    assert bool((teng.pools["k"] == before).all())


def _fresh_and_enqueue_copy_script(eng, opcodes):
    """``memcopy(..., dst_is_fresh=...)`` on the engine and on a stream,
    and ``CommandQueue.enqueue_copy``; returns the per-flush launches and
    the mechanism counts."""
    eng.alloc.mark_written(list(range(1, 32)))
    out = [eng.memcopy([(1, 2), (3, 20)], dst_is_fresh=True),
           eng.memcopy([(5, 6)], dst_is_fresh=False)]
    s = eng.stream("fresh")
    out.append(s.memcopy([(7, 8), (9, 24)], dst_is_fresh=True))
    out.append(s.flush().launches)
    q = eng.queue
    q.enqueue_copy(opcodes.OP_FPM_COPY, [(10, 11), (12, 13)])
    q.enqueue_copy(opcodes.OP_BASELINE_COPY, [(14, 15)])
    out.append((len(q), q.flush()))
    return out


@pytest.mark.parametrize("use_fused", [True, False])
def test_memcopy_dst_is_fresh_and_enqueue_copy_match_reference(use_fused):
    """The reference's ``memcopy(pairs, dst_is_fresh=...)`` (engine and
    stream) and ``CommandQueue.enqueue_copy(opcode, pairs)``: the same
    counts, launches, journal rows and stats, and bitwise pools."""
    import repro.core.opcodes as jops
    import repro_torch.core.opcodes as tops
    jeng = mk_engine(32, 1, use_fused=use_fused, stage_nblk=8, seed=3)
    teng = port_engine_like(jeng)
    events_j = []
    hook = lambda n, p, m: events_j.append((n, p, m))  # noqa: E731
    jfd.add_launch_hook(hook)
    try:
        got_j = _fresh_and_enqueue_copy_script(jeng, jops)
    finally:
        jfd.remove_launch_hook(hook)
    with PortHook() as events_t:
        got_t = _fresh_and_enqueue_copy_script(teng, tops)
    assert got_t == got_j
    assert events_t == events_j
    assert journal_rows(teng) == journal_rows(jeng)
    j_stats, t_stats = common_stats(jeng, teng)
    assert t_stats == j_stats
    assert_same_pools(jeng, teng, f"(fused={use_fused})")
