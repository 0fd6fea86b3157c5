"""The port's remaining ServingEngine features against the JAX ServingEngine,
on the reduced llama3.2-3b with the JAX weights carried across
(``from_jax_params``): dedup-on-admit, demote / resume over the spill pools,
the double-buffered and adaptive staging ring, and the ``fused_staging=False``
leg, plus the copies they need (``xor_fold`` / ``page_fingerprint``, the
metrics registry, ``make_serving_pools``).

* greedy tokens are identical; before each compared round every live
  sequence's top-1 / top-2 logit margin is asserted to exceed twice the
  logit tolerance (as in test_torch_serve.py), so a differing token could
  only come from a real divergence;
* dedup and ring counters, engine stats, launch events and byte counters
  are equal to the JAX engine's; blocks moved by demote / resume are
  bitwise equal to their sources.
"""
import random
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import PortHook
from test_torch_serve import LOGIT_ATOL, _JaxHook, _margin

import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.core import RowCloneEngine as JEngine
from repro.core import SubarrayAllocator as JAlloc
from repro.models import build_model, split_params
from repro.models.paged import make_serving_pools as jmake_pools
from repro.obs import metrics as jmetrics
import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.paged import make_serving_pools
from repro_torch.obs import metrics as tmetrics
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("llama3.2-3b").reduced()
    params, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config("llama3.2-3b").reduced()
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             cfg, device="cpu")
    return jcfg, params, cfg, tmodel


def _pair(served, **kw):
    """The JAX engine and the port's, built with the same arguments."""
    jcfg, params, cfg, tmodel = served
    return (jserve.ServingEngine(jcfg, params, **kw),
            ServingEngine(cfg, tmodel, device="cpu", **kw))


def _guard(jeng):
    """Every live sequence's next greedy token is decided by a margin
    above twice the logit tolerance."""
    for sid in jeng.cache.seqs:
        m = _margin(jeng.last_logits[sid])
        assert m > 2 * LOGIT_ATOL, (sid, m)


def _rounds(jeng, teng, n):
    """``n`` guarded rounds on both engines; returns the per-round launch
    mechanisms of each."""
    mj, mt = [], []
    for _ in range(n):
        _guard(jeng)
        with _JaxHook() as ev_j, PortHook() as ev_t:
            toks_j = jeng.decode_round()
            toks_t = teng.decode_round()
        assert toks_t == toks_j
        mj.append([m for _, _, m in ev_j])
        mt.append([m for _, _, m in ev_t])
    return mj, mt


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _pools_close(jeng, teng, names=("k", "v")):
    for n in names:
        np.testing.assert_allclose(_np(teng.engine.pools[n]),
                                   _np(jeng.engine.pools[n]),
                                   atol=LOGIT_ATOL, err_msg=n)


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(2, vocab, size=n).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the copies: fingerprint, metrics registry, make_serving_pools
# ---------------------------------------------------------------------------

def test_fingerprint_matches_reference():
    """``xor_fold`` and ``page_fingerprint`` equal the reference's on
    seeded 64-bit words and chained token pages (full pages, a short tail
    page, an empty page)."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 63, size=(200, 2), dtype=np.int64)
    for a, b in words.tolist():
        a, b = a * 2 + 1, b ^ (1 << 63)
        assert tserve.xor_fold(a, b) == jserve.xor_fold(a, b) == a ^ b
    for seed in range(5):
        chain_t = chain_j = 0
        toks = _prompt(seed, 64 * 3 + 17)
        for j in range(4):
            page = toks[j * 64:(j + 1) * 64]
            chain_t = tserve.page_fingerprint(chain_t, page)
            chain_j = jserve.page_fingerprint(chain_j, page)
            assert chain_t == chain_j
    assert tserve.page_fingerprint(7, []) == jserve.page_fingerprint(7, [])


def _emit(m):
    m.inc("serve.ring_shrinks")
    m.inc("queue.enqueued", 3, stream="serve")
    m.set_gauge("serve.ring_limit", 4)
    m.set_gauge("engine.stage_limit", 2.5, pool="k")
    m.observe("sched.round_us", 125.0)
    m.observe("sched.round_us", 75.5)


def _series(m):
    return m.snapshot()


def test_metrics_registry_matches_reference():
    """The port's registry records the same series as the reference's for
    one emission script (snapshot of counters, gauges and histograms,
    reads, disable, reset)."""
    t, j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _emit(t)
    _emit(j)
    assert _series(t) == _series(j)
    assert t.get("queue.enqueued", stream="serve") == 3.0
    assert t.gauge_value("serve.ring_limit") == j.gauge_value(
        "serve.ring_limit") == 4.0
    assert t.gauge_value("never") is None and t.get("never") == 0.0
    assert t.hist("sched.round_us") == j.hist("sched.round_us") == [
        125.0, 75.5]
    t.enabled = j.enabled = False
    _emit(t)
    _emit(j)
    assert _series(t) == _series(j)
    t.reset()
    j.reset()
    assert _series(t) == _series(j) == {"counters": {}, "gauges": {},
                                        "histograms": {}}
    prev = tmetrics.set_metrics_enabled(False)
    assert prev is True and not tmetrics.metrics_enabled()
    tmetrics.set_metrics_enabled(prev)
    with tmetrics.Stopwatch() as sw:
        pass
    assert sw.s >= 0.0 and sw.us == sw.s * 1e6


@pytest.mark.parametrize("kw", [
    dict(stage_nblk=4),
    dict(staging=False),
    dict(stage_nblk=6, ckpt_nblk=4),
    dict(staging=False, ckpt_nblk=8),
])
def test_make_serving_pools_matches_reference(kw):
    """make_serving_pools' group (names, order, block counts, roles,
    pairing, base offsets) and pool shapes equal the reference's."""
    args = (2, 16, 4, 2, 8)
    tpools, tgroup = make_serving_pools(*args, torch.float32, "cpu", **kw)
    jpools, jgroup = jmake_pools(*args, jnp.float32, **kw)
    assert list(tpools) == list(jpools)
    for n in tpools:
        assert tuple(tpools[n].shape) == jpools[n].shape
    assert [(s.name, s.nblk, s.role, s.paired) for s in tgroup] == \
        [(s.name, s.nblk, s.role, s.paired) for s in jgroup]
    assert [tgroup.base(s.name) for s in tgroup] == \
        [jgroup.base(s.name) for s in jgroup]


# ---------------------------------------------------------------------------
# dedup-on-admit
# ---------------------------------------------------------------------------

def _dedup_counters(eng):
    return (eng.dedup_hits, eng.dedup_pages_shared, eng.dedup_bytes_saved,
            eng.kv_bytes_live())


def test_dedup_identical_prompts_share_blocks_bitwise_tokens(served):
    """Two tenants admit the same prompt (reference
    test_serving_staging.py:498): the dupe's three pages, the partial
    tail included, run on the donor's blocks; the counters and resident
    bytes equal the JAX engine's, tokens equal the JAX engine's and a
    dedup-off run's, and the first append CoW-splits the shared tail."""
    jon, ton = _pair(served, max_seqs=8, dedup_admit=True)
    _, params, cfg, tmodel = served
    toff = ServingEngine(cfg, tmodel, max_seqs=8, device="cpu")
    page = ton.cache.page
    prompt = _prompt(5, 2 * page + page // 2)
    for eng in (jon, ton, ton, jon, toff, toff):
        eng.add_request(prompt.copy())
    a, b = sorted(ton.cache.seqs)
    assert ton.cache.blocks_of(a) == ton.cache.blocks_of(b)
    assert ton.dedup_hits == 1 and ton.dedup_pages_shared == 3
    assert _dedup_counters(ton) == _dedup_counters(jon)
    assert ton.kv_bytes_live() < toff.kv_bytes_live()
    assert ton.cache.blocks_of(b) == jon.cache.blocks_of(b)
    mj, mt = _rounds(jon, ton, 3)
    assert mt == mj and all(len(m) <= (2 if r == 0 else 1)
                            for r, m in enumerate(mt)), mt
    for _ in range(3):
        toff.decode_round()
    assert ton.tokens == jon.tokens == toff.tokens
    ba, bb = ton.cache.blocks_of(a), ton.cache.blocks_of(b)
    assert ba[:2] == bb[:2] and ba[2] != bb[2]
    assert all(ton.engine.alloc.is_shared(blk) for blk in ba[:2])
    assert _dedup_counters(ton) == _dedup_counters(jon)
    assert ton.engine.stats == ton.engine.stats.__class__(
        **{k: getattr(jon.engine.stats, k)
           for k in ton.engine.stats.__dataclass_fields__})
    _pools_close(jon, ton)


def test_dedup_shares_only_common_prefix_pages(served):
    """Prompts agreeing on their first pages share exactly those
    (reference :541); a page whose tokens recur at another position does
    not match (chained fingerprint).  Blocks and counters equal the JAX
    engine's."""
    jon, ton = _pair(served, max_seqs=8, dedup_admit=True)
    page = ton.cache.page
    p1 = _prompt(9, 3 * page)
    p2 = p1.copy()
    p2[-1] = 2 + (int(p2[-1]) - 1) % 510
    p3 = np.concatenate([p1[:page], p1[:page], p1[:page]])
    for p in (p1, p2, p3):
        assert ton.add_request(p.copy()) == jon.add_request(p.copy())
    ba, bb, bc = (ton.cache.blocks_of(s) for s in range(3))
    assert ba[:2] == bb[:2] and ba[2] != bb[2]
    assert bc[0] == ba[0] and bc[1] not in ba
    assert ton.dedup_pages_shared == 3
    for s in range(3):
        assert ton.cache.blocks_of(s) == jon.cache.blocks_of(s)
    assert _dedup_counters(ton) == _dedup_counters(jon)
    mj, mt = _rounds(jon, ton, 2)
    assert mt == mj
    assert ton.tokens == jon.tokens


def test_dedup_registry_drops_with_registering_sequence(served):
    """After the donor frees, a re-admission is a clean miss and becomes
    the next donor (reference :570); free of a donor whose promotion is
    still queued retires only the rows no live dupe depends on."""
    jon, ton = _pair(served, max_seqs=8, dedup_admit=True)
    prompt = _prompt(13, 2 * ton.cache.page)
    for eng in (jon, ton):
        a = eng.add_request(prompt.copy())
        eng.free(a)
        assert eng.dedup_hits == 0 and eng.engine.stats.retired_promotions
        b = eng.add_request(prompt.copy())
        assert eng.dedup_hits == 0
        c = eng.add_request(prompt.copy())
        assert eng.dedup_hits == 1
        assert eng.cache.blocks_of(b) == eng.cache.blocks_of(c)
        eng.free(b)            # c still shares b's blocks: keep the rows
    assert ton.engine.stats.retired_promotions == \
        jon.engine.stats.retired_promotions
    assert _dedup_counters(ton) == _dedup_counters(jon)
    assert len(ton.stream) == len(jon.stream.queue) > 0
    mj, mt = _rounds(jon, ton, 2)
    assert mt == mj == [["fused"], []]
    assert ton.tokens == jon.tokens
    _pools_close(jon, ton)


# ---------------------------------------------------------------------------
# demote / resume
# ---------------------------------------------------------------------------

def test_demote_resume_roundtrip_moves_bytes():
    """The engine primitives (reference test_serving_staging.py:176):
    demote_to_spill parks a block's bytes in one spill slot per pool
    pair, promote_spilled lands them back in fresh blocks bitwise, the
    slots return to the free list; slots, stats and pools equal the JAX
    engine's on the same data."""
    L, nblk, page = 2, 16, 2
    tpools, tgroup = make_serving_pools(L, nblk, page, 2, 4, torch.float32,
                                        "cpu", stage_nblk=4, ckpt_nblk=4)
    jpools, jgroup = jmake_pools(L, nblk, page, 2, 4, jnp.float32,
                                 stage_nblk=4, ckpt_nblk=4)
    talloc, jalloc = (SubarrayAllocator(nblk, 4, reserved_zero_per_slab=1),
                      JAlloc(nblk, 4, reserved_zero_per_slab=1))
    teng = RowCloneEngine(tpools, talloc, block_axis=1, group=tgroup)
    jeng = JEngine(jpools, jalloc, block_axis=1, group=jgroup)
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((L, 2, page, 2, 4)).astype(np.float32)
            for n in ("k", "v")}
    slots = {}
    for eng, alloc in ((teng, talloc), (jeng, jalloc)):
        eng.enable_demotion(range(4))
        blocks = alloc.alloc(2)
        idx = np.asarray(blocks)
        for n in ("k", "v"):
            if eng is teng:
                eng.pools[n][:, idx] = torch.from_numpy(data[n])
            else:
                eng.pools[n] = eng.pools[n].at[:, idx].set(data[n])
        alloc.mark_written(blocks)
        slots[eng is teng] = s = eng.demote_to_spill(blocks)
        assert eng.spill_slots_free == eng.spill_capacity - 2
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                _np(eng.pools[n + "_spill"])[:, np.asarray(s)], data[n])
        alloc.free(blocks)
        fresh = alloc.alloc(2)
        eng.promote_spilled(list(zip(s, fresh)))
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                _np(eng.pools[n])[:, np.asarray(fresh)], data[n])
        assert eng.stats.demotions == 2 and eng.stats.spill_promotions == 2
        assert eng.spill_slots_free == eng.spill_capacity
        eng.release_spill_slots(s)
        assert eng.spill_slots_free == eng.spill_capacity
    assert slots[True] == slots[False]
    for n in tpools:
        np.testing.assert_array_equal(_np(teng.pools[n]), _np(jeng.pools[n]))
    pools, group = make_serving_pools(L, nblk, page, 2, 4, torch.float32,
                                      "cpu")
    bare = RowCloneEngine(pools, SubarrayAllocator(nblk, 4), block_axis=1,
                          group=group)
    with pytest.raises(RuntimeError, match="no spill pools"):
        bare.enable_demotion([0])
    with pytest.raises(RuntimeError, match="not enabled"):
        bare.demote_to_spill([0])


SCHED_KW = dict(max_seqs=4, max_blocks_per_seq=8, num_slabs=2,
                max_admit_pages=8, double_buffer=True, spill_pages=8)
#: prompt seed of the preemption script; with it every compared greedy
#: step keeps a top-1 / top-2 margin above 2 x LOGIT_ATOL
PREEMPT_SEED = 27
PREEMPT_LENS = (20, 45, 70)


def test_preempt_demote_resume_matches_reference(served):
    """Serving-level preemption: admit 3, two rounds, demote the second
    sequence, two rounds, resume it, three rounds.  Tokens, launch events
    (<= 1 a round, the demote and resume rows riding the round's one
    launch), stats and spill slots equal the JAX engine's; the parked and
    resumed blocks equal their sources bitwise; the resumed sequence's
    tokens equal an unpreempted run's."""
    jeng, teng = _pair(served, **SCHED_KW)
    _, _, cfg, tmodel = served
    plain = ServingEngine(cfg, tmodel, device="cpu", **SCHED_KW)
    prompts = [_prompt(PREEMPT_SEED + i, n)
               for i, n in enumerate(PREEMPT_LENS)]
    for eng in (jeng, teng, plain):
        assert [eng.add_request(p.copy()) for p in prompts] == [0, 1, 2]
    mech_j, mech_t = _rounds(jeng, teng, 2)
    for _ in range(7):
        plain.decode_round()
    victim = teng.cache.blocks_of(1)
    before = {n: teng.engine.pools[n][:, victim].clone() for n in ("k", "v")}
    jeng.demote(1)
    teng.demote(1)
    slots = teng.demoted[1].slots
    assert slots == jeng.demoted[1].slots
    assert teng.engine.spill_slots_free == 8 - len(victim)
    m = _rounds(jeng, teng, 1)
    mech_j, mech_t = mech_j + m[0], mech_t + m[1]
    for n in ("k", "v"):
        assert torch.equal(teng.engine.pools[n + "_spill"][:, slots],
                           before[n])
    assert teng.engine.alloc.total_free() == jeng.engine.alloc.total_free()
    m = _rounds(jeng, teng, 1)
    mech_j, mech_t = mech_j + m[0], mech_t + m[1]
    assert jeng.resume(1) == teng.resume(1) == 3
    fresh = teng.cache.blocks_of(3)
    assert fresh == jeng.cache.blocks_of(3)
    landed = {}
    hook = (lambda *a: landed.update(
        {n: teng.engine.pools[n][:, fresh].clone() for n in ("k", "v")}))
    from repro_torch.kernels import fused_dispatch as tfd
    tfd.add_launch_hook(hook)
    try:
        m = _rounds(jeng, teng, 3)
    finally:
        tfd.remove_launch_hook(hook)
    mech_j, mech_t = mech_j + m[0], mech_t + m[1]
    for n in ("k", "v"):
        assert torch.equal(landed[n], before[n])
    assert mech_t == mech_j and all(len(x) <= 1 for x in mech_t), mech_t
    assert teng.tokens == jeng.tokens
    resumed = teng.tokens[3]
    assert resumed == plain.tokens[1][:len(resumed)]
    s_t, s_j = teng.engine.stats, jeng.engine.stats
    assert (s_t.demotions, s_t.spill_promotions, s_t.launches) == \
        (s_j.demotions, s_j.spill_promotions, s_j.launches)
    assert s_t.demotions == s_t.spill_promotions == len(victim)
    assert teng.engine.spill_slots_free == teng.engine.spill_capacity == 8
    assert teng.kv_bytes_live() == jeng.kv_bytes_live()


def test_demote_while_staged_is_refused(served):
    """A sequence admitted this round cannot be demoted (reference
    test_scheduler.py:265); the next round it can, and free of the
    demoted sid releases its spill slots."""
    for eng in _pair(served, **SCHED_KW):
        sid = eng.add_request(_prompt(1, 9))
        with pytest.raises(RuntimeError, match="not drained"):
            eng.demote(sid)
        eng.decode_round()
        eng.demote(sid)
        assert sid in eng.demoted and eng.engine.spill_slots_free == 7
        assert eng.decode_round() == {}       # empty batch still drains
        assert len(eng.engine.queue) == 0 and eng.engine.stats.demotions
        eng.free(sid)
        assert eng.engine.spill_slots_free == eng.engine.spill_capacity
        assert sid not in eng.demoted
        assert eng.engine.alloc.total_free() == eng.engine.num_blocks - \
            eng.engine.alloc.num_slabs


def test_caller_stream_routes_admission_and_preemption(served):
    """``stream=`` puts an admission's promotion, a demotion and a resume
    on a caller stream (a scheduler lane) instead of the serve stream;
    each drains at the lane's flush as one launch, as on the JAX
    engine."""
    got = []
    for eng in _pair(served, **SCHED_KW):
        lane = eng.engine.stream("lane")
        serve_len = (lambda: len(eng.stream.queue))
        sid = eng.add_request(_prompt(2, 70), stream=lane)
        rows = [len(lane.queue), serve_len()]
        flushes = [lane.flush().launches]
        _guard(eng)
        eng.decode_round()
        eng.demote(sid, stream=lane)
        rows += [len(lane.queue), serve_len()]
        flushes.append(lane.flush().launches)
        new = eng.resume(sid, stream=lane)
        rows += [len(lane.queue), serve_len()]
        flushes.append(lane.flush().launches)
        _guard(eng)
        eng.decode_round()
        got.append((rows, flushes, new, eng.tokens[new],
                    eng.engine.spill_slots_free))
    assert got[0] == got[1]
    rows, flushes = got[1][:2]
    assert rows == [4, 0, 4, 0, 4, 0] and flushes == [1, 1, 1]


# ---------------------------------------------------------------------------
# the staging ring
# ---------------------------------------------------------------------------

def _random_plan(seed, n_rounds=5, vocab=512):
    """The reference's random admit / fork / decode plan
    (test_serving_staging.py ``_random_rounds`` / ``_drive_rounds``): per
    round, a list of ("admit", prompt) / ("fork", admission index)."""
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    n_admitted = 0
    plan = []
    for rnd in range(n_rounds):
        ops = []
        if rnd == 0 or (rng.random() < 0.7 and n_admitted < 5):
            ops.append(("admit", prng.integers(
                2, vocab, size=rng.choice([9, 16, 24])).astype(np.int32)))
        if n_admitted and rng.random() < 0.4:
            ops.append(("fork", rng.choice(list(range(n_admitted)))))
        n_admitted += sum(op == "admit" for op, _ in ops)
        plan.append(ops)
    return plan


def _drive(eng, plan):
    """Run a :func:`_random_plan` on ``eng``; returns the per-round launch
    mechanisms."""
    sids, rounds = [], []
    for ops in plan:
        with PortHook() as ev:
            for op, arg in ops:
                if op == "admit":
                    sids.append(eng.add_request(arg.copy()))
                else:
                    eng.fork(sids[arg], 1)
            eng.decode_round()
        rounds.append([m for _, _, m in ev])
    return rounds


def test_staging_ring_halves_memory_bitwise_tokens(served):
    """A staging ring of 8 slots against full twins (reference
    test_serving_staging.py:367): identical tokens, bitwise K/V pools, one
    fused launch a round, >= 1.8x fewer resident bytes, each engine's
    resident bytes equal to the JAX engine's."""
    _, _, cfg, tmodel = served
    kw = dict(max_seqs=8, max_blocks_per_seq=16, device="cpu")
    twin = ServingEngine(cfg, tmodel, max_admit_pages=ServingEngine.FULL_TWIN,
                         **kw)
    ring = ServingEngine(cfg, tmodel, max_admit_pages=8, **kw)
    assert ring.engine.stage_capacity == 8 < ring.engine.num_blocks
    plan = _random_plan(3)
    _drive(twin, plan)
    rounds = _drive(ring, plan)
    assert twin.tokens == ring.tokens
    for n in ("k", "v"):
        assert torch.equal(twin.engine.pools[n], ring.engine.pools[n])
    assert all(m in ([], ["fused"]) for m in rounds), rounds
    assert twin.pool_bytes_resident() / ring.pool_bytes_resident() >= 1.8
    jtwin, jring = (jserve.ServingEngine(served[0], served[1], max_seqs=8,
                                         max_blocks_per_seq=16,
                                         max_admit_pages=m)
                    for m in (0, 8))
    assert ring.pool_bytes_resident() == jring.engine.pool_bytes_resident()
    assert twin.pool_bytes_resident() == jtwin.engine.pool_bytes_resident()


def _burst(eng, n_rounds=2, admits=3, prompt_len=24):
    prng = np.random.default_rng(11)
    rounds = []
    for _ in range(n_rounds):
        with PortHook() as ev:
            for _ in range(admits):
                eng.add_request(prng.integers(2, 512, size=prompt_len)
                                .astype(np.int32))
            eng.decode_round()
        rounds.append([m for _, _, m in ev])
    return rounds


def test_burst_admissions_double_buffered_one_launch(served):
    """Three one-page admissions a round against a 2-slot ring (reference
    test_serving_staging.py:414): the double-buffered ring drains each
    round as ONE launch, the single-buffered one pays an early flush, and
    tokens and K/V pools equal across double, single and legacy staging;
    the launch events equal the JAX engines'."""
    _, _, cfg, tmodel = served
    kw = dict(max_seqs=8, max_blocks_per_seq=16)
    double = ServingEngine(cfg, tmodel, max_admit_pages=2,
                           double_buffer=True, device="cpu", **kw)
    single = ServingEngine(cfg, tmodel, max_admit_pages=2, device="cpu",
                           **kw)
    legacy = ServingEngine(cfg, tmodel, fused_staging=False, device="cpu",
                           **kw)
    assert double.ring_capacity == 2 and double.engine.stage_capacity == 4
    assert single.engine.stage_capacity == 2
    assert not legacy.engine.staging
    r_double, r_single, r_legacy = (_burst(e) for e in (double, single,
                                                        legacy))
    assert double.tokens == single.tokens == legacy.tokens
    for n in ("k", "v"):
        assert torch.equal(double.engine.pools[n], single.engine.pools[n])
        assert torch.equal(double.engine.pools[n], legacy.engine.pools[n])
    assert r_double == [["fused"], ["fused"]]
    assert any(len(m) > 1 for m in r_single), r_single
    assert r_legacy == [["legacy_stage"] * 6] * 2
    t = double.last_ticket
    assert t.stream == "serve" and t.launches == 1
    jdouble = jserve.ServingEngine(served[0], served[1], max_admit_pages=2,
                                   double_buffer=True, **kw)
    jsingle = jserve.ServingEngine(served[0], served[1], max_admit_pages=2,
                                   **kw)
    for jeng, want in ((jdouble, r_double), (jsingle, r_single)):
        prng = np.random.default_rng(11)
        got = []
        for _ in range(2):
            with _JaxHook() as ev:
                for _ in range(3):
                    jeng.add_request(prng.integers(2, 512, size=24)
                                     .astype(np.int32))
                jeng.decode_round()
            got.append([m for _, _, m in ev])
        assert got == want
    assert double.tokens == jdouble.tokens


def test_burst_ticket_and_slot_lifetime(served):
    """While a burst's promotions are queued their staging slots hold
    pending reads and stay off the free list; the round's one launch
    recycles every slot (reference test_serving_staging.py:449)."""
    _, _, cfg, tmodel = served
    eng = ServingEngine(cfg, tmodel, max_seqs=8, max_blocks_per_seq=16,
                        max_admit_pages=2, double_buffer=True, device="cpu")
    sidx = [eng.engine.group.index(n) for n in eng.engine.staging]
    for i in range(3):
        eng.add_request(_prompt(5 + i, 24))
        inflight = list(eng.engine._stage_inflight)
        assert len(inflight) == i + 1
        assert all(eng.stream.queue.has_pending_read((p, s))
                   for s in inflight for p in sidx)
    eng.decode_round()
    assert eng.engine._stage_inflight == []
    assert len(eng.engine._stage_free) == eng.engine.stage_capacity
    assert eng.last_ticket.launches == 1


def test_ring_exhaustion_flushes_and_recycles(served):
    """Admissions beyond a one-slot ring inside a round force an early
    drain instead of failing (reference test_serving_staging.py:473); the
    launch events and stats equal the JAX engine's."""
    jeng, teng = _pair(served, max_seqs=8, max_blocks_per_seq=16,
                       max_admit_pages=1)
    events = []
    for eng, hook in ((jeng, _JaxHook()), (teng, PortHook())):
        with hook as ev:
            for i in range(3):
                eng.add_request(_prompt(i, 9))
            eng.decode_round()
        events.append([m for _, _, m in ev])
        assert eng.engine.stats.stage_promotions == 3
        assert len(eng.engine._stage_free) == eng.engine.stage_capacity
    assert events[0] == events[1] == ["fused"] * 3, events
    assert teng.engine.stats.launches == jeng.engine.stats.launches == 3
    assert teng.tokens == jeng.tokens


#: prompt seeds of the adaptive-ring script; with them every compared
#: greedy step keeps a top-1 / top-2 margin above 2 x LOGIT_ATOL
RING_SEEDS = (2, 3)


def _clamp(eng):
    return (eng.ring_shrinks, eng.engine.stage_limit,
            len(eng.engine._stage_parked))


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_ring_matches_reference(served, adaptive):
    """A 24-token admission and 2 x RING_WINDOW + 1 idle rounds clamp the
    ring, and a two-page admission against the clamp reopens it before
    reserving (reference test_obs.py:343); with the controller off it
    never clamps (:379).  Shrinks, regrows, limits, parked slots, tokens
    and the ``serve.*`` / ``engine.stage_limit`` series equal the JAX
    engine's, in the port's own registry."""
    jeng, teng = _pair(served, max_seqs=8, max_blocks_per_seq=16,
                       max_admit_pages=8, adaptive_ring=adaptive)
    tmetrics.reset()
    jmetrics.registry().reset()
    for eng in (jeng, teng):
        eng.add_request(_prompt(RING_SEEDS[0], 24))
    _rounds(jeng, teng, 2 * ServingEngine.RING_WINDOW + 1)
    assert _clamp(teng) == _clamp(jeng)
    shrinks, limit, parked = _clamp(teng)
    if adaptive:
        assert shrinks >= 1 and limit is not None and limit < 8 and parked
        for eng in (jeng, teng):
            eng.add_request(_prompt(RING_SEEDS[1], 100))
        assert teng.ring_regrows == jeng.ring_regrows >= 1
        assert teng.engine.stage_limit is None
        _rounds(jeng, teng, 1)
    else:
        assert (shrinks, limit, parked) == (0, None, 0)
    assert teng.tokens == jeng.tokens
    treg, jreg = tmetrics.registry(), jmetrics.registry()
    for name in ("serve.ring_shrinks", "serve.ring_regrows"):
        assert treg.get(name) == jreg.get(name)
    for name in ("serve.ring_limit", "serve.ring_occupancy",
                 "engine.stage_limit"):
        assert treg.gauge_value(name) == jreg.gauge_value(name), name
    assert treg.get("serve.ring_shrinks") == teng.ring_shrinks
    eng = teng.engine
    assert len(eng._stage_free) + len(eng._stage_parked) == \
        eng.stage_capacity


# ---------------------------------------------------------------------------
# the fused_staging=False leg
# ---------------------------------------------------------------------------

#: prompt seed of the legacy-leg script (the test_torch_serve.py protocol);
#: with it every greedy step of the JAX legacy leg keeps a top-1 / top-2
#: margin above 2 x LOGIT_ATOL
LEGACY_SEED = 27


def test_legacy_leg_matches_reference_legacy_leg(served):
    """``fused_staging=False`` against the JAX engine's legacy leg: admit
    three prompts, a round, fork the first into 2, two more rounds.  Each
    admission writes the K/V pools directly as two ``legacy_stage`` events
    (one per pool) and no K1 launch; tokens, launch events, stats and pool
    bytes equal the JAX legacy leg's."""
    jeng, teng = _pair(served, max_seqs=8, fused_staging=False)
    assert not teng.engine.staging and teng.engine.stage_capacity == 0
    prompts = [_prompt(LEGACY_SEED + i, n)
               for i, n in enumerate((20, 45, 70))]
    with _JaxHook() as ev_j, PortHook() as ev_t:
        for p in prompts:
            assert jeng.add_request(p.copy()) == teng.add_request(p.copy())
    assert ev_t == ev_j
    assert [m for _, _, m in ev_t] == ["legacy_stage"] * 6
    assert [n for n, _, _ in ev_t] == [1, 1, 1, 1, 2, 2]
    mj, mt = _rounds(jeng, teng, 1)
    assert jeng.fork(0, 2) == teng.fork(0, 2)
    m = _rounds(jeng, teng, 2)
    assert mt + m[1] == mj + m[0]
    assert teng.tokens == jeng.tokens
    assert teng.engine.stats == teng.engine.stats.__class__(
        **{k: getattr(jeng.engine.stats, k)
           for k in teng.engine.stats.__dataclass_fields__})
    assert teng.pool_bytes_resident() == jeng.engine.pool_bytes_resident()
    _pools_close(jeng, teng)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_leg_equals_legacy_leg_bitwise(served, seed):
    """The reference's A/B (test_serving_staging.py:300) on the port: the
    same random admit / fork / decode rounds through the fused and the
    legacy leg give bitwise-equal K/V pools and identical tokens, every
    fused round at most one ``fused`` launch, and no legacy staging on the
    fused leg."""
    _, _, cfg, tmodel = served
    fused = ServingEngine(cfg, tmodel, max_seqs=8, device="cpu")
    legacy = ServingEngine(cfg, tmodel, max_seqs=8, fused_staging=False,
                           device="cpu")
    plan = _random_plan(seed)
    r_fused = _drive(fused, plan)
    r_legacy = _drive(legacy, plan)
    for n in ("k", "v"):
        assert torch.equal(fused.engine.pools[n], legacy.engine.pools[n]), n
    assert fused.tokens == legacy.tokens
    assert all(m in ([], ["fused"]) for m in r_fused), r_fused
    assert any("legacy_stage" in m for m in r_legacy)
    assert fused.engine.stats.stage_promotions > 0
    assert legacy.engine.stats.stage_promotions == 0


def test_reference_failing_test_is_a_prefill_near_tie(served):
    """What the reference's failing A/B (test_serving_staging.py
    ``test_serving_rounds_bitwise_parity_one_launch``, seed 1) shows: its
    two legs run the prefill differently (one jit with the staging
    scatter, against the eager model.prefill), and the second admission's
    9-token prompt is a near-tie: the fused leg's top-2 logits differ by
    less than 1e-3, the legacy leg's (like the port's, whose legs share
    one prefill) tie exactly after rounding.  Their first generated tokens
    differ (511 / 496), and the K pools then differ only in that
    sequence's block 255 at positions 9-12 (its generated tokens); the
    staged prompt pages are equal.  The port's legs stay bitwise equal on
    the same plan.  ``pytest -s`` prints the margins."""
    jcfg, params, cfg, tmodel = served
    plan = _random_plan(1)
    engines = {"fused": jserve.ServingEngine(jcfg, params, max_seqs=8),
               "legacy": jserve.ServingEngine(jcfg, params, max_seqs=8,
                                              fused_staging=False),
               "port": ServingEngine(cfg, tmodel, max_seqs=8,
                                     device="cpu"),
               "port legacy": ServingEngine(cfg, tmodel, max_seqs=8,
                                            fused_staging=False,
                                            device="cpu")}
    prefill = {}
    for name, eng in engines.items():
        sids = []
        for ops in plan:
            for op, arg in ops:
                if op == "admit":
                    sids.append(eng.add_request(arg.copy()))
                    if len(sids) == 2:
                        prefill[name] = np.array(eng.last_logits[1])
                else:
                    eng.fork(sids[arg], 1)
            eng.decode_round()
    top = {n: np.argsort(lg)[-2:][::-1] for n, lg in prefill.items()}
    margin = {n: float(lg[top[n][0]] - lg[top[n][1]])
              for n, lg in prefill.items()}
    for n in engines:
        print(f"[near-tie] {n}: prefill top-2 tokens {top[n].tolist()}, "
              f"logits {prefill[n][top[n]].tolist()}, margin "
              f"{margin[n]:.6g}, first generated token "
              f"{engines[n].tokens[1][9]}")
    assert set(top["fused"]) == set(top["legacy"]) == {496, 511}
    assert 0 < margin["fused"] < 1e-3
    assert margin["legacy"] == margin["port"] == margin["port legacy"] == 0
    assert engines["fused"].tokens[1][9] == 511
    assert engines["legacy"].tokens[1][9] == 496
    diff = [s for s in engines["fused"].tokens
            if engines["fused"].tokens[s] != engines["legacy"].tokens[s]]
    assert diff == [1]
    kf, kl = (np.asarray(engines[n].engine.pools["k"])
              for n in ("fused", "legacy"))
    where = np.argwhere(kf != kl)
    assert set(where[:, 1]) == {255} and set(where[:, 2]) == {9, 10, 11, 12}
    assert engines["fused"].cache.blocks_of(1) == [255]
    for n in ("k", "v"):
        assert torch.equal(engines["port"].engine.pools[n],
                           engines["port legacy"].engine.pools[n])
    assert engines["port"].tokens == engines["port legacy"].tokens == \
        engines["legacy"].tokens


# ---------------------------------------------------------------------------
# constructor refusals and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "item 12"),
    (dict(fault_plan="plan"), "item 9"),
    (dict(auto_recover=True), "item 9"),
    (dict(ckpt_pages=4), "item 9"),
    (dict(ckpt_dir="dir"), "item 9"),
    (dict(ckpt_window=2), "item 9"),
])
def test_unported_arguments_raise(served, kw, item, tmp_path):
    """The arguments ROADMAP items 9 and 12 brought are no longer refused.
    ``mesh`` (item 12) has left ``NOT_PORTED``: a non-mesh raises
    TypeError, a ``DeviceMesh`` builds an engine over its ranks, and the
    default (off) builds one on the device.  The fault-tolerance
    arguments of item 9 each build, or raise, as the JAX engine does with
    them (``ckpt_pages`` without ``ckpt_dir`` raises ValueError in both;
    ``fault_plan`` is each package's own ``FaultPlan``)."""
    jcfg, params, cfg, tmodel = served
    name = next(iter(kw))
    if item == "item 12":
        from repro_torch.launch.mesh import make_test_mesh
        assert name not in tserve.NOT_PORTED
        with pytest.raises(TypeError, match="DeviceMesh"):
            ServingEngine(cfg, tmodel, max_seqs=2, max_blocks_per_seq=2,
                          device="cpu", **kw)
        mesh = make_test_mesh((2, 2), ("data", "model"), devices="cpu")
        eng = ServingEngine(cfg, tmodel, max_seqs=2, max_blocks_per_seq=2,
                            mesh=mesh)
        assert eng.engine.n_shards == 4 and eng.cache.batch_groups == 2
        eng = ServingEngine(cfg, tmodel, max_seqs=2, max_blocks_per_seq=2,
                            device="cpu", mesh=None)
        assert eng.engine.n_shards == 1
    else:
        import repro.runtime.fault as jfault
        import repro_torch.runtime.fault as tfault
        assert name not in tserve.NOT_PORTED
        outcome = []
        for make, fault in ((lambda **a: jserve.ServingEngine(
                jcfg, params, **a), jfault),
                (lambda **a: ServingEngine(cfg, tmodel, device="cpu", **a),
                 tfault)):
            args = dict(kw)
            if name == "fault_plan":
                args[name] = fault.FaultPlan()
            if name == "ckpt_dir":
                args[name] = str(tmp_path / "ckpt")
            try:
                eng = make(max_seqs=2, max_blocks_per_seq=2, **args)
            except ValueError as e:
                outcome.append(("ValueError", str(e)))
                continue
            outcome.append((eng.auto_recover, eng.pool_ckpt is None,
                            eng.engine.spill_capacity,
                            len(eng.engine.group.names)))
        assert outcome[1] == outcome[0]
    with pytest.raises(TypeError):
        ServingEngine(cfg, tmodel, device="cpu", not_an_argument=1)


def test_serve_cli_double_buffer_matches_reference(capsys, monkeypatch):
    """``--double-buffer`` doubles the CLI's staging ring as the JAX CLI's
    does: the same staging slots and RowClone stats."""
    args = ["--requests", "2", "--steps", "2", "--double-buffer"]
    outs = []
    for main, argv in ((jserve.main, ["serve", *args]),
                       (tserve.main, ["serve", "--smoke", "--device", "cpu",
                                      *args])):
        monkeypatch.setattr(sys, "argv", argv)
        main()
        out = capsys.readouterr().out
        slots = re.search(r"staging slots: (\d+) of (\d+)", out).groups()
        line = next(ln for ln in out.splitlines() if "rowclone:" in ln)
        stats = dict(re.findall(r"([\w-]+)=(\d+)", line))
        outs.append((slots, {k: stats[k] for k in
                             ("fpm", "psm", "alias", "lazy-zero")}))
    assert outs[0] == outs[1]
    assert outs[1][0] == ("128", "512")
