"""The port's per-mechanism fan-out drain (``RowCloneEngine(use_fused=False)``)
against the JAX fan-out, and against the port's own fused drain.

* seeded random streams (``gen_program`` of test_dispatch_properties.py)
  over both block axes: the same pools bitwise, the same ``EngineStats``
  (``launches`` included), journal rows, queue stats and sequence of
  ``legacy_*`` launch tags;
* the fixed A/B script of ``launch/mechanisms.py`` (every mechanism, an
  FPM run longer than ``max_requests`` carrying a write-after-read pair):
  the fan-out count :data:`AB_FANOUT_LAUNCHES` on both packages, one fused
  launch, three engines bitwise equal;
* ports of the fused-vs-fan-out regressions of ``tests/test_dispatch.py``,
  plus a write-after-read pair inside one FPM run;
* the GPU runs a K5 call's pairs concurrently: with the copy entries
  replaced by an emulation that runs each call's pairs wave by wave
  (``pair_waves``), inside a wave in REVERSE enqueue order (a writer
  before its reader, were they in one wave), one pair at a time, the
  fan-out still matches the JAX engine.
"""
import random

import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from test_dispatch_properties import gen_program, mk_engine, run_program
from test_torch_contract import (PortHook, assert_same_pools, bits,
                                 common_stats, journal_rows,
                                 port_engine_like, queue_stats,
                                 run_program_port)

import repro.core.poolspec as jps
from repro.kernels import fused_dispatch as jfd
from repro_torch.core import rowclone as trc
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.poolspec import BlockRef
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.kernels import fpm_copy as tfpm
from repro_torch.kernels import ref
from repro_torch.launch import mechanisms


def assert_parity(jeng, teng, ev_j, ev_t, ctx):
    assert ev_t == ev_j, ctx
    assert journal_rows(teng) == journal_rows(jeng), ctx
    assert queue_stats(teng.queue) == queue_stats(jeng.queue), ctx
    j_stats, t_stats = common_stats(jeng, teng)
    assert t_stats == j_stats, ctx
    np.testing.assert_array_equal(teng.alloc.is_zero, jeng.alloc.is_zero)
    assert_same_pools(jeng, teng, ctx)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10**6), st.integers(0, 1), st.integers(1, 8),
       st.integers(0, 2))
def test_fanout_matches_reference(seed, block_axis, n_instr, stage_shift):
    rng = random.Random(seed)
    nblk = rng.choice([32, 64])
    stage_nblk = nblk >> stage_shift
    prog = gen_program(rng, nblk, n_instr, stage_nblk=stage_nblk)
    jeng = mk_engine(nblk, block_axis, use_fused=False,
                     stage_nblk=stage_nblk)
    teng = port_engine_like(jeng)
    assert not teng.use_fused and teng.max_requests == jeng.max_requests
    ev_j = run_program(jeng, prog)
    ev_t = run_program_port(teng, prog)
    assert all(m.startswith("legacy_") for _, _, m in ev_t)
    assert_parity(jeng, teng, ev_j, ev_t, f"(seed={seed} prog={prog})")


class JaxHook:
    def __enter__(self):
        self.events = []
        self._fn = lambda n, p, mech: self.events.append((n, p, mech))
        jfd.add_launch_hook(self._fn)
        return self.events

    def __exit__(self, *exc):
        jfd.remove_launch_hook(self._fn)


def ab_engines(block_axis, use_fused, nblk=4096):
    jeng = mk_engine(nblk, block_axis, use_fused=use_fused, stage_nblk=64,
                     seed=11)
    jeng.max_requests = 256                  # the engines' default
    return jeng, port_engine_like(jeng)


@pytest.mark.parametrize("block_axis", [0, 1])
def test_ab_program_launch_count_and_pools(block_axis):
    """The chip smoke's fused-vs-fan-out script: the JAX and the port
    fan-out issue :data:`AB_FANOUT_LAUNCHES` launches with the same tags,
    the fused drain one, and all pools agree bitwise."""
    prog = mechanisms.ab_program(4096)
    jeng, teng = ab_engines(block_axis, use_fused=False)
    with JaxHook() as ev_j:
        mechanisms.drive(jeng, prog, block_ref=jps.BlockRef)
    with PortHook() as ev_t:
        mechanisms.drive(teng, prog)
    assert jeng.stats.launches == mechanisms.AB_FANOUT_LAUNCHES
    assert_parity(jeng, teng, ev_j, ev_t, "(A/B fan-out)")
    tags = {m for _, _, m in ev_t}
    assert tags == {"legacy_fpm", "legacy_psm", "legacy_baseline",
                    "legacy_zero", "legacy_cross", "legacy_bitwise"}
    assert teng.queue.stats.war_hazards >= 1
    assert teng.journal.records[-1].launches == \
        mechanisms.AB_FANOUT_LAUNCHES
    _, fused = ab_engines(block_axis, use_fused=True)
    with PortHook() as ev_f:
        mechanisms.drive(fused, prog)
    assert fused.stats.launches == 1 and [m for _, _, m in ev_f] == ["fused"]
    for name in teng.pools:
        np.testing.assert_array_equal(bits(fused.pools[name]),
                                      bits(teng.pools[name]), err_msg=name)


# ---------------------------------------------------------------------------
# fused vs fan-out inside the port (ports of tests/test_dispatch.py)
# ---------------------------------------------------------------------------

def port_engine(block_axis=0, use_fused=True, seed=0, nblk=64):
    rng = np.random.default_rng(seed)
    shape = (nblk, 8, 2, 16) if block_axis == 0 else (2, nblk, 8, 16)
    pools = {n: torch.from_numpy(rng.standard_normal(shape)
                                 .astype(np.float32)) for n in ("k", "v")}
    return RowCloneEngine(pools, SubarrayAllocator(nblk, 4), block_axis=
                          block_axis, use_fused=use_fused)


def blk(eng, name, b):
    return eng.pools[name].select(eng.block_axis, b).clone()


@pytest.mark.parametrize("use_fused", [True, False])
def test_war_ordering_fused_and_fanout_agree(use_fused):
    """(PSM b->nb) then (FPM c->b): nb gets b's OLD bytes, b gets c's."""
    eng = port_engine(use_fused=use_fused, seed=17)
    b, nb, c = 3, 33, 7
    eng.alloc.mark_written([b, c])
    old_b, old_c = blk(eng, "k", b), blk(eng, "k", c)
    with eng.batch():
        counts1 = eng.memcopy([(b, nb)])
        counts2 = eng.memcopy([(c, b)])
    assert counts1["psm"] == 1 and counts2["fpm"] == 1
    assert torch.equal(blk(eng, "k", nb), old_b)
    assert torch.equal(blk(eng, "k", b), old_c)


@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("use_fused", [True, False])
def test_war_pair_inside_one_fpm_run(use_fused, block_axis):
    """(FPM a->b) then (FPM c->a) share ONE fan-out call: b must receive
    the OLD a, as on the fused drain (on the card K5a orders the pair by
    its wave schedule)."""
    eng = port_engine(block_axis, use_fused=use_fused, seed=19)
    a, b, c = 2, 5, 9                      # all in slab 0
    eng.alloc.mark_written([a, c])
    old_a, old_c = blk(eng, "v", a), blk(eng, "v", c)
    with PortHook() as events:
        with eng.batch():
            eng.memcopy([(a, b)])
            eng.memcopy([(c, a)])
    assert torch.equal(blk(eng, "v", b), old_a)
    assert torch.equal(blk(eng, "v", a), old_c)
    want = ["fused"] if use_fused else ["legacy_fpm", "legacy_fpm"]
    assert [m for _, _, m in events] == want


@pytest.mark.parametrize("use_fused", [True, False])
def test_cross_pool_war_interleaved_directions(use_fused):
    """k1->v2, v5->k6, k7->v5: k6 must get v5's OLD bytes."""
    eng = port_engine(seed=29, use_fused=use_fused)
    eng.alloc.mark_written([1, 5, 7])
    old_v5 = blk(eng, "v", 5)
    with eng.batch():
        eng.memcopy_cross([(BlockRef("k", 1), BlockRef("v", 2))])
        eng.memcopy_cross([(BlockRef("v", 5), BlockRef("k", 6))])
        eng.memcopy_cross([(BlockRef("k", 7), BlockRef("v", 5))])
    assert torch.equal(blk(eng, "k", 6), old_v5)
    assert torch.equal(blk(eng, "v", 5), blk(eng, "k", 7))
    assert torch.equal(blk(eng, "v", 2), blk(eng, "k", 1))


def test_fanout_cross_pool_axis1():
    """block_axis=1 cross-pool copies index the block axis, not the layer
    axis (40 >= L would hit the layer axis if misindexed)."""
    eng = port_engine(block_axis=1, use_fused=False, seed=23)
    eng.alloc.mark_written([5])
    want = blk(eng, "k", 5)
    eng.memcopy_cross([(BlockRef("k", 5), BlockRef("v", 40))])
    assert torch.equal(blk(eng, "v", 40), want)


def test_fanout_chunks_and_marks_written_pools():
    """A run of 300 FPM rows at max_requests=256 is two calls per pool;
    every pool a call wrote moves to a new generation."""
    eng = port_engine(nblk=4096, use_fused=False)   # slabs of 1024
    pairs = [(1 + i, 301 + i) for i in range(300)]
    before = dict(eng.pool_generation)
    with PortHook() as events:
        eng.memcopy(pairs)
    assert [(n, m) for n, _, m in events] == [(256, "legacy_fpm")] * 4
    assert eng.stats.launches == 4
    assert all(eng.pool_generation[n] == before[n] + 2 for n in before)


# ---------------------------------------------------------------------------
# the kernels' concurrency, emulated on the CPU
# ---------------------------------------------------------------------------

def _emulate(dst_pool, src_pool, ids, block_axis, same_pool):
    """What K5 does with one call: live rows (padding dropped, sources
    clipped), waves from :func:`pair_waves`, the pairs of a wave in any
    order — here the reverse of enqueue order, one at a time."""
    rows = tfpm._live_pairs(ids, src_pool.shape[block_axis],
                            dst_pool.shape[block_axis])
    waves = tfpm.pair_waves(rows, same_pool=same_pool)
    for w in range(max(waves, default=-1) + 1):
        for i in reversed([i for i, x in enumerate(waves) if x == w]):
            ref.fpm_copy_cross(dst_pool, src_pool, [rows[i]],
                               block_axis=block_axis)
    return dst_pool


def _emulate_kernels(monkeypatch):
    monkeypatch.setattr(trc.kops, "fpm_copy", lambda p, ids, block_axis:
                        _emulate(p, p, ids, block_axis, True))
    monkeypatch.setattr(
        trc.kops, "fpm_copy_cross", lambda d, s, ids, block_axis:
        _emulate(d, s, ids, block_axis, d is s))


@pytest.mark.parametrize("seed", range(6))
def test_fanout_with_emulated_concurrent_kernels(seed, monkeypatch):
    rng = random.Random(seed)
    block_axis = seed % 2
    nblk = 32
    prog = gen_program(rng, nblk, 8, stage_nblk=16)
    jeng = mk_engine(nblk, block_axis, use_fused=False, stage_nblk=16)
    teng = port_engine_like(jeng)
    _emulate_kernels(monkeypatch)
    ev_j = run_program(jeng, prog)
    ev_t = run_program_port(teng, prog)
    assert_parity(jeng, teng, ev_j, ev_t, f"(seed={seed})")


@pytest.mark.parametrize("block_axis", [0, 1])
def test_ab_program_with_emulated_concurrent_kernels(block_axis,
                                                     monkeypatch):
    """The A/B script's FPM run carries an in-call WAR pair: under the
    emulated concurrency the port still matches the JAX fan-out."""
    jeng, teng = ab_engines(block_axis, use_fused=False)
    _emulate_kernels(monkeypatch)
    prog = mechanisms.ab_program(4096)
    with JaxHook() as ev_j:
        mechanisms.drive(jeng, prog, block_ref=jps.BlockRef)
    with PortHook() as ev_t:
        mechanisms.drive(teng, prog)
    assert_parity(jeng, teng, ev_j, ev_t, "(A/B, emulated kernels)")
