"""The port's traffic layer against the JAX package's, on the reduced
llama3.2-3b with the JAX weights carried across (``from_jax_params``):
``RequestScheduler``, ``CommandStream.adopt`` / ``CommandQueue.abort``, the
metric histograms and the Fig. 3/4 / traffic / dedup drivers
(``repro_torch.launch.multitenant`` against
``benchmarks/fig34_multitenant.py``).

* the reference's four scheduler scripts (``tests/test_scheduler.py``) run
  on both packages: ``RoundReport`` sequences equal apart from the three
  wall-clock fields, requests (states, sids, rounds, tokens) equal, journal
  rows, queue stats and engine stats equal, and the K/V and spill pools
  within the logit tolerance of the JAX engine's (the two packages' fp32
  arithmetic differs in the last bits; the zero blocks agree exactly).
  Tokens are compared exactly; a mismatch names the sequences whose top-1
  / top-2 margin was at most twice the logit tolerance on the way (the
  reference's seeds meet such near-ties, and the tokens agree through
  them);
* inside the port the bytes that demotion parks and resumption brings back
  are bitwise equal to their sources;
* ``run_traffic`` (16 rounds, poisson and bursty) gives a ``TrafficResult``
  equal to the reference's apart from ``goodput_tok_s``; ``run_dedup`` the
  same row; one ``_run_mix`` leg with RowClone off and one on leave the
  same engine stats, launch events and pools.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_dispatch_properties import mk_engine
from test_torch_contract import (PortHook, bits, common_stats, journal_rows,
                                 port_engine_like, queue_stats)
from test_torch_serve import LOGIT_ATOL, _JaxHook, _margin

import repro.launch.scheduler as jsched
import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.models import build_model, split_params
from repro.obs import metrics as jmetrics
import repro_torch.launch.scheduler as tsched
from repro_torch.configs import get_config
from repro_torch.kernels import fused_dispatch as tfd
from repro_torch.launch import multitenant as tmt
from repro_torch.launch.serve import ServingEngine
from repro_torch.obs import metrics as tmetrics
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]


def _load_reference_driver():
    spec = importlib.util.spec_from_file_location(
        "fig34_multitenant", ROOT / "benchmarks" / "fig34_multitenant.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


jmt = _load_reference_driver()

#: RoundReport fields read from the host clock
WALL_FIELDS = ("round_us", "p50_round_us", "p99_round_us")
PARITY_TOKENS = 8
TRAFFIC_ROUNDS = 16


def _weights(arch):
    jcfg = jget_config(arch).reduced()
    params, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config(arch).reduced()
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             cfg, device="cpu")
    return jcfg, params, cfg, tmodel


@pytest.fixture(scope="module")
def served():
    return _weights("llama3.2-3b")


def _sched_engines(served, **kw):
    """The reference's undersized scheduler engine (test_scheduler.py
    ``_sched_engine``), JAX and port, built with the same arguments."""
    jcfg, params, cfg, tmodel = served
    base = dict(max_seqs=4, max_blocks_per_seq=8, num_slabs=2,
                max_admit_pages=8, double_buffer=True, spill_pages=8)
    base.update(kw)
    return (jserve.ServingEngine(jcfg, params, **base),
            ServingEngine(cfg, tmodel, device="cpu", **base))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the histograms of obs/metrics.py
# ---------------------------------------------------------------------------

def _emit(m):
    m.inc("lane.admitted", tenant="gold")
    m.inc("lane.tokens", 3, tenant="free")
    m.set_gauge("serve.ring_limit", 4)
    for v in (5.0, 1.0, 9.5, 2.25):
        m.observe("sched.round_us", v)
    m.observe("drain.flush_us", 7, stream="serve")


@pytest.mark.parametrize("cap", [4096, 3])
def test_histograms_match_reference(cap):
    """observe / hist / series / snapshot / reset of the port's registry
    equal the reference's on one emission script, at the default sample
    cap and at a cap that drops the oldest samples; off emits nothing."""
    t, j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    t.hist_cap = j.hist_cap = cap
    assert tmetrics.MetricsRegistry().hist_cap == 4096
    for m in (t, j):
        _emit(m)
    assert t.snapshot() == j.snapshot()
    assert t.hist("sched.round_us") == j.hist("sched.round_us")
    assert t.hist("drain.flush_us", stream="serve") == [7.0]
    assert t.hist("never") == j.hist("never") == []
    assert t.series("lane.tokens") == j.series("lane.tokens") == {
        (("tenant", "free"),): 3.0}
    t.enabled = j.enabled = False
    for m in (t, j):
        _emit(m)
    assert t.snapshot() == j.snapshot()
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


@pytest.mark.parametrize("xs", [[], [3.0], [4.0, 1.0, 2.5, 8.0, 8.0],
                                list(np.random.default_rng(0).exponential(
                                    100.0, size=257))])
def test_percentile_and_summarize_match_reference(xs):
    """percentile (linear interpolation, 0.0 on an empty input) and
    summarize equal the reference's; the module-level observe writes the
    process registry; time_us returns reps samples."""
    for q in (0, 1, 50, 90, 99, 100):
        assert tmetrics.percentile(xs, q) == jmetrics.percentile(xs, q)
    assert tmetrics.summarize(xs) == jmetrics.summarize(xs)
    tmetrics.reset()
    for x in xs:
        tmetrics.observe("t", x, k=1)
    assert tmetrics.registry().hist("t", k=1) == [float(x) for x in xs]
    tmetrics.reset()
    calls = []
    out = tmetrics.time_us(lambda: calls.append(1), warmup=1, reps=3)
    assert len(out) == 3 and len(calls) == 4 and min(out) >= 0.0


# ---------------------------------------------------------------------------
# CommandQueue.abort and CommandStream.adopt
# ---------------------------------------------------------------------------

def _engines_small():
    jeng = mk_engine(32, 1, use_fused=True, stage_nblk=8)
    return jeng, port_engine_like(jeng)


def test_abort_matches_reference():
    """abort() returns the pending rows in order, clears both hazard maps,
    leaves the engine's live set and dispatches nothing."""
    jeng, teng = _engines_small()
    got = {}
    for name, eng, hook in (("jax", jeng, _JaxHook()),
                            ("port", teng, PortHook())):
        lane = eng.stream("lane")
        lane.memcopy([(4, 9), (5, 10)])
        lane.meminit([12], lazy=False)
        with hook as events:
            rows = lane.queue.abort()
        got[name] = (rows, lane.pending, lane.queue._pending_dsts,
                     lane.queue._pending_srcs, list(eng._live_queues),
                     events, lane.queue.abort())
    assert got["port"][0] == got["jax"][0] and len(got["port"][0]) == 3
    for part in got.values():
        assert part[1:] == ([], {}, {}, [], [], [])
    for n in jeng.pools:
        np.testing.assert_array_equal(bits(jeng.pools[n]),
                                      bits(teng.pools[n]))


def _adopt_script(eng):
    """Two lanes and the serve stream: lane ``a`` copies 4->9 and 5->10
    and zeroes 13; lane ``b`` copies 14->15, then 17->14 (a WAR on its own
    pending read).  Both are adopted into the serve stream, which then
    flushes.  Returns what the adoption left."""
    serve, a, b = eng.stream("serve"), eng.stream("a"), eng.stream("b")
    a.memcopy([(4, 9), (5, 10)])
    a.meminit([13], lazy=False)
    b.memcopy([(14, 15)])
    b.memcopy([(17, 14)])
    counts = (serve.adopt(serve), serve.adopt(a), serve.adopt(b),
              serve.adopt(b))
    left = (serve.pending, len(a), len(b), a.queue._pending_dsts,
            b.queue._pending_srcs,
            sorted(q.name for q in eng._live_queues.values()))
    ticket = serve.flush()
    return (counts, left, ticket.commands, ticket.launches,
            queue_stats(serve.queue), queue_stats(a.queue),
            queue_stats(b.queue), eng.stats.cross_stream_flushes)


def test_adopt_matches_reference():
    """adopt(): self-adoption and adopting an empty lane are 0; the lanes'
    rows move in adoption order and the lanes are left empty and out of
    the live set; re-enqueueing re-runs the hazard matrix (the serve
    stream counts lane ``b``'s WAR again and spaces it at the flush); the
    adoption costs no launch and no cross-stream flush, so the serve
    flush is the only launch.  Journal rows, queue stats and pools equal
    the reference's bitwise."""
    jeng, teng = _engines_small()
    with _JaxHook() as ev_j:
        j = _adopt_script(jeng)
    with PortHook() as ev_t:
        t = _adopt_script(teng)
    assert t == j
    counts, left, commands, launches, sq, aq, bq, cross = t
    assert counts == (0, 3, 2, 0)
    assert [r[1:] for r in left[0]] == [(4, 9), (5, 10), (-1, 13), (14, 15),
                                        (17, 14)]
    assert left[1:] == (0, 0, {}, {}, ["serve"])
    assert (commands, launches) == (5, 1)
    assert bq["war_hazards"] == sq["war_hazards"] == 1
    assert sq["hazard_flushes"] == 0 and sq["spacer_rows"] == 1
    assert cross == 0 and aq["launches"] == bq["launches"] == 0
    assert [m for _, _, m in ev_t] == [m for _, _, m in ev_j] == ["fused"]
    assert journal_rows(teng) == journal_rows(jeng)
    for n in jeng.pools:
        np.testing.assert_array_equal(bits(jeng.pools[n]),
                                      bits(teng.pools[n]))


# ---------------------------------------------------------------------------
# the reference's scheduler scripts (tests/test_scheduler.py:145-296)
# ---------------------------------------------------------------------------

class _Guard:
    """Before every scheduler round, records each live sequence whose next
    greedy token is decided by a margin of at most twice the logit
    tolerance (read on the JAX engine), for the message of a token
    mismatch."""

    def __init__(self, sched):
        self.step = sched.step
        self.low = []
        sched.step = self

    def __call__(self, *a, **kw):
        eng = self.step.__self__.eng
        self.low += [(s, _margin(lg)) for s, lg in eng.last_logits.items()
                     if s in eng.cache.seqs and
                     _margin(lg) <= 2 * LOGIT_ATOL]
        return self.step(*a, **kw)


class _ParkWatch:
    """On the port's engine: the bytes each demotion parks in the spill
    slots, and those each resumption brings back, checked bitwise at the
    fused launch that moves them."""

    def __init__(self, eng):
        self.eng, self.todo, self.checked = eng, [], 0
        self._demote, self._resume = eng.demote, eng.resume
        eng.demote, eng.resume = self.demote, self.resume

    def demote(self, sid, stream=None):
        pools = self.eng.engine.pools
        blocks = self.eng.cache.blocks_of(sid)
        before = {n: pools[n][:, blocks].clone() for n in ("k", "v")}
        self._demote(sid, stream=stream)
        self.todo.append((self.eng.demoted[sid].slots, "_spill", before))

    def resume(self, sid, stream=None):
        pools = self.eng.engine.pools
        slots = self.eng.demoted[sid].slots
        parked = {n: pools[n + "_spill"][:, slots].clone()
                  for n in ("k", "v")}
        new = self._resume(sid, stream=stream)
        self.todo.append((self.eng.cache.blocks_of(new), "", parked))
        return new

    def __call__(self, n, p, mech):
        pools = self.eng.engine.pools
        for ids, suffix, want in self.todo:
            for name in ("k", "v"):
                assert torch.equal(pools[name + suffix][:, ids].view(
                    torch.uint8), want[name].view(torch.uint8)), (ids, name)
            self.checked += 1
        self.todo = []


def _mk(cfg, seed):
    prng = np.random.default_rng(seed)
    return lambda n: prng.integers(2, cfg.vocab_size, size=n).astype(
        np.int32)


def _script_continuous(S, eng, cfg):
    """Staggered admissions and retirements across two lanes."""
    sched = S.RequestScheduler(eng, [S.TenantSpec("gold", 1),
                                     S.TenantSpec("free", 0)])
    guard = _Guard(sched)
    mk = _mk(cfg, 3)
    plan = {0: [("free", 9), ("free", 16)], 1: [("gold", 9)],
            3: [("free", 24)]}
    r = 0
    while not sched.idle or r < 5:
        for tenant, plen in plan.get(r, []):
            sched.submit(tenant, mk(plen), max_new_tokens=4)
        sched.step()
        r += 1
        assert r < 60, "scheduler failed to drain"
    return sched, guard


def _script_preempt(S, eng, cfg):
    """Two free requests fill a 2-slot engine; a gold arrival preempts."""
    sched = S.RequestScheduler(eng, [S.TenantSpec("gold", 2),
                                     S.TenantSpec("free", 0)])
    guard = _Guard(sched)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(3)]
    sched.submit("free", prompts[0], max_new_tokens=PARITY_TOKENS)
    sched.submit("free", prompts[1], max_new_tokens=PARITY_TOKENS)
    sched.step()
    sched.step()
    sched.submit("gold", prompts[2], max_new_tokens=PARITY_TOKENS)
    sched.drain(max_rounds=120)
    return sched, guard


def _script_cancel(S, eng, cfg):
    """cancel() of a parked, a running and a queued request."""
    sched = S.RequestScheduler(eng, [S.TenantSpec("gold", 1),
                                     S.TenantSpec("free", 0)])
    guard = _Guard(sched)
    mk = _mk(cfg, 7)
    r_free = [sched.submit("free", mk(9), max_new_tokens=32),
              sched.submit("free", mk(9), max_new_tokens=32)]
    sched.step()
    sched.step()
    r_gold = sched.submit("gold", mk(9), max_new_tokens=4)
    sched.step()                        # demotes one free victim
    parked = next(r for r in r_free
                  if sched.requests[r].state == "preempted")
    running = next(r for r in r_free if r != parked)
    sched.cancel(parked)                # spill parking released
    assert eng.engine.spill_slots_free == eng.engine.spill_capacity
    sched.cancel(running)               # live sequence freed
    r_q = sched.submit("free", mk(9), max_new_tokens=4)
    sched.cancel(r_q)                   # still queued: just dequeued
    sched.drain(max_rounds=60)          # gold still completes
    assert sched.requests[r_gold].state == "done"
    assert len(sched.requests[r_gold].tokens_out) == 4
    assert eng.cache.seqs == {}
    return sched, guard


def _script_staged(S, eng, cfg):
    """An engine script: demote in the admission round is refused, the
    next round it parks, and freeing the parked sequence releases it."""
    sid = eng.add_request(_mk(cfg, 1)(9))
    with pytest.raises(RuntimeError, match="not drained"):
        eng.demote(sid)
    eng.decode_round()
    eng.demote(sid)
    assert sid in eng.demoted
    eng.free(sid)
    assert eng.engine.spill_slots_free == eng.engine.spill_capacity
    return None, None


SCRIPTS = {"continuous_batching_reclaim": (_script_continuous, {}),
           "preemption_parity": (_script_preempt, {"max_seqs": 2}),
           "cancel_in_every_state": (_script_cancel, {"max_seqs": 2}),
           "demote_while_staged_refused": (_script_staged, {})}


def _reports(sched):
    out = []
    for rep in sched.reports:
        d = dataclasses.asdict(rep)
        for f in WALL_FIELDS:
            assert np.isfinite(d[f]) and d[f] >= 0.0, (f, d[f])
            d.pop(f)
        out.append(d)
    return out


def _requests(sched):
    return {rid: {**dataclasses.asdict(q), "prompt": q.prompt.tolist()}
            for rid, q in sched.requests.items()}


def _pools_agree(jeng, teng):
    """Every pool within the logit tolerance, and the same blocks all
    zero, exactly."""
    for n, tp in teng.engine.pools.items():
        j, t = _np(jeng.engine.pools[n]), _np(tp)
        np.testing.assert_allclose(t, j, atol=LOGIT_ATOL, err_msg=n)
        zj = np.all(np.moveaxis(j, 1, 0).reshape(j.shape[1], -1) == 0, 1)
        zt = np.all(np.moveaxis(t, 1, 0).reshape(t.shape[1], -1) == 0, 1)
        np.testing.assert_array_equal(zt, zj, err_msg=n)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scheduler_script_matches_reference(served, name):
    """One of the reference's scheduler scripts on both packages: equal
    RoundReports (apart from the wall-clock fields), requests and tokens,
    journal rows, queue and engine stats, launch events; pools within
    the logit tolerance; <= 1 launch a round; the port's parked and
    resumed bytes bitwise equal to their sources."""
    script, kw = SCRIPTS[name]
    jeng, teng = _sched_engines(served, **kw)
    watch = _ParkWatch(teng)
    tfd.add_launch_hook(watch)
    try:
        with _JaxHook() as ev_j:
            jres, guard = script(jsched, jeng, served[0])
        with PortHook() as ev_t:
            tres, _ = script(tsched, teng, served[2])
    finally:
        tfd.remove_launch_hook(watch)
    assert [m for _, _, m in ev_t] == [m for _, _, m in ev_j]
    if jres is not None:
        assert _reports(tres) == _reports(jres)
        # a differing token names the near-ties met on the way
        assert _requests(tres) == _requests(jres), guard.low
        assert max(r.launches for r in tres.reports) <= 1
        for tl, jl in zip(tres.lanes.values(), jres.lanes.values()):
            assert queue_stats(tl.stream.queue) == \
                queue_stats(jl.stream.queue)
    assert queue_stats(teng.stream.queue) == queue_stats(jeng.stream.queue)
    assert journal_rows(teng.engine) == journal_rows(jeng.engine)
    j, t = common_stats(jeng.engine, teng.engine)
    assert t == j
    _pools_agree(jeng, teng)
    if name == "preemption_parity":
        # the reference's tight-against-roomy claim, on the port: the
        # preempted run's tokens equal a roomy engine's that never preempts
        reps = tres.reports
        assert sum(q.preemptions for q in tres.requests.values()) > 0
        demote_round = next(r.round_index for r in reps if r.preempted)
        admit_round = next(r.round_index for r in reps if 2 in r.admitted)
        assert admit_round == demote_round + 1
        assert any(r.resumed for r in reps)
        assert watch.checked == 2 * sum(
            len(r.preempted) for r in reps) and watch.checked > 0
        _, roomy = _sched_engines(served, max_seqs=8, num_slabs=4,
                                  spill_pages=0)
        rres, _ = script(tsched, roomy, served[2])
        assert sum(q.preemptions for q in rres.requests.values()) == 0
        assert [q.tokens_out for q in tres.requests.values()] == \
            [q.tokens_out for q in rres.requests.values()]
    if name == "continuous_batching_reclaim":
        eng = teng.engine
        assert all(q.state == "done" for q in tres.requests.values())
        assert eng.alloc.total_free() == eng.alloc.num_blocks - len(
            eng.alloc.zero_rows)
        assert len(eng._stage_free) + len(eng._stage_parked) == \
            eng.stage_capacity
        assert eng.spill_slots_free == eng.spill_capacity


# ---------------------------------------------------------------------------
# the drivers: run_traffic, run_dedup, the Fig. 3/4 mix
# ---------------------------------------------------------------------------

def _traffic_fields(res):
    d = {f: getattr(res, f) for f in
         ("pattern", "rounds", "launches", "per_tenant", "preempted_rids",
          "completed", "submitted")}
    d["per_tenant"] = {t: {k: v for k, v in m.items()
                           if k != "goodput_tok_s"}
                       for t, m in d["per_tenant"].items()}
    for m in res.per_tenant.values():
        assert np.isfinite(m["goodput_tok_s"]) and m["goodput_tok_s"] >= 0
    return d


@pytest.mark.parametrize("pattern", ["poisson", "bursty"])
def test_run_traffic_matches_reference(served, pattern):
    """run_traffic over the reference's undersized engine: the same
    TrafficResult (goodput apart), every round's RoundReport schedule
    fields equal to a replay of the recorded arrival script, and the
    script's shape."""
    jeng, _ = _sched_engines(served)
    jres = jmt.run_traffic(pattern, rounds=TRAFFIC_ROUNDS, seed=0, eng=jeng)
    tres = tmt.run_traffic(pattern, rounds=TRAFFIC_ROUNDS, seed=0,
                           eng=tmt.traffic_engine(served[2], served[3]))
    assert _traffic_fields(tres) == _traffic_fields(jres)
    assert tres.max_launches_per_round() == jres.max_launches_per_round()
    assert len(tres.arrivals) == tres.submitted
    assert [r.launches for r in tres.reports] == tres.launches
    replay = tmt.run_traffic(pattern, rounds=TRAFFIC_ROUNDS, seed=1,
                             eng=tmt.traffic_engine(served[2], served[3]),
                             script=tres.arrivals)
    assert replay.arrivals == tres.arrivals
    assert [_schedule(r) for r in replay.reports] == \
        [_schedule(r) for r in tres.reports]


def _schedule(rep):
    return (rep.round_index, rep.admitted, rep.finished, rep.preempted,
            rep.resumed, rep.tokens)


def test_run_dedup_matches_reference(served):
    """run_dedup's row equals the reference's on the same weights."""
    jcfg, params, cfg, tmodel = served
    j = jmt.run_dedup(rounds=4, seed=0, cfg=jcfg, params=params)
    t = tmt.run_dedup(rounds=4, seed=0, cfg=cfg, params=tmodel)
    assert t == j
    assert t["tokens_match"] and t["max_launches_per_round"] <= 1


@pytest.fixture(scope="module")
def yi():
    return _weights("yi-6b")


@pytest.mark.parametrize("on", [False, True])
def test_run_mix_leg_matches_reference(yi, monkeypatch, on):
    """One Fig. 3/4 leg (2 copy tenants beside 2 plain ones) with RowClone
    off or on: the same engine stats, launch events and tokens as the
    reference's, pools within the logit tolerance."""
    jcfg, params, cfg, tmodel = yi
    made = {}
    for mod, key in ((jmt, "jax"), (tmt, "port")):
        cls = mod.ServingEngine

        class Kept(cls):
            def __init__(self, *a, _key=key, **kw):
                super().__init__(*a, **kw)
                made[_key] = self
        monkeypatch.setattr(mod, "ServingEngine", Kept)
    with _JaxHook() as ev_j:
        tj = jmt._run_mix(jcfg, params, 2, 2, on)
    with PortHook() as ev_t:
        tt = tmt._run_mix(cfg, tmodel, 2, 2, on)
    assert tj > 0 and tt > 0
    jeng, teng = made["jax"], made["port"]
    assert [m for _, _, m in ev_t] == [m for _, _, m in ev_j]
    j, t = common_stats(jeng.engine, teng.engine)
    assert t == j
    # off: every forked block copied up front, one launch per copy
    assert (t["baseline_copies"] > 0) is not on
    assert teng.tokens == jeng.tokens
    _pools_agree(jeng, teng)
