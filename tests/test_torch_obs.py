"""The port's observability half against the JAX package's, on the same
scripts (``tests/test_obs.py:69-281`` run on both packages).

* the drain-side counters of a scripted flush equal its journal record
  exactly, and the port's ``drain.*`` / ``queue.*`` / ``engine.bytes_*``
  series and histogram sample counts equal the reference's, on the
  scripted flush, on the dispatch property streams and on a recovery
  scenario whose replays drain as stream ``"replay"``;
* ``FlushTicket.timing`` (None on an empty flush);
* spans: ``flush -> drain`` and ``ticket-wait`` give the same ``(name,
  depth, parent, labels)`` sequence on both packages; tracing off records
  nothing; a drain that raises leaves the span stack empty;
* ``TunedProfile``: JSON round trip, engine precedence (kwarg > profile >
  default), a profile either package saved loads in the other, a
  malformed file gives None, ``pick_winner``'s margin rule, and a quick
  ``launch/autotune.py`` run writing a loadable profile;
* metrics and tracing on or off leave the pools bitwise equal.

Tolerances: counters exact, pools bitwise, spans structurally equal; no
time is compared.  Profiles go to ``tmp_path`` through
``REPRO_TUNED_DIR``; ``configs/tuned/`` is never written.
"""
import random

import jax
import numpy as np
import pytest
import torch

from test_dispatch_properties import gen_program, mk_engine as jax_prop_engine
from test_dispatch_properties import run_program
from test_obs import _scripted_rounds
from test_obs import mk_engine as jax_obs_engine
from test_torch_contract import (assert_same_pools, bits, port_engine_like,
                                 run_program_port, to_torch)
from test_torch_recovery import (JAX, PORT,
                                 sc_launch_failure_recovers_bitwise,
                                 sc_midflush_abort_journals_prefix_and_redrains)

import repro.core as jcore
import repro.obs.autotune as jauto
import repro.obs.metrics as jobs
import repro.obs.trace as jtrace
import repro_torch.core.cmdqueue as tcmdqueue
import repro_torch.obs.autotune as tauto
import repro_torch.obs.metrics as tobs
import repro_torch.obs.trace as ttrace
from repro.core.opcodes import OP_CROSS_POOL_COPY, OPCODE_NAMES
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.poolspec import BlockRef
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.core.stream import FlushTicket
from repro_torch.launch import autotune as tlaunch_autotune


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts from empty registries and span rings on both
    packages, and leaves metrics, tracing and the buckets at their
    defaults."""
    for reg in (jobs.registry(), tobs.registry()):
        reg.reset()
    jtrace.reset_spans()
    ttrace.reset_spans()
    yield
    for m, t in ((jobs, jtrace), (tobs, ttrace)):
        m.registry().reset()
        t.reset_spans()
        m.set_metrics_enabled(True)
        t.set_tracing(True)
    tcmdqueue.set_buckets(None)


#: the series the core emits
SERIES = ("drain.rows", "drain.spacer_rows", "drain.launches",
          "queue.enqueued", "queue.hazard_flushes", "queue.war_hazards",
          "queue.retired", "engine.bytes_moved", "engine.bytes_avoided")
HISTS = ("drain.flush_us", "drain.table_len")


def series_of(m):
    """Every core counter series, and each histogram's sample count."""
    reg = m.registry()
    out = {name: reg.series(name) for name in SERIES}
    out["hist_n"] = {k: len(v) for k, v in reg.hists.items()
                     if k[0] in HISTS}
    return out


def table_lens(m):
    return {k: v for k, v in m.registry().hists.items()
            if k[0] == "drain.table_len"}


def span_shape(records):
    return [(r.name, r.depth, r.parent, r.labels) for r in records]


def both_engines(seed=0):
    """test_obs.py's engine, and the port's on the same bytes."""
    jeng = jax_obs_engine(seed=seed)
    return jeng, port_engine_like(jeng)


def port_obs_engine(seed=0):
    """The port's counterpart of test_obs.py's engine."""
    jeng = jax_obs_engine(seed=seed)
    a = jeng.alloc
    return RowCloneEngine({n: to_torch(p) for n, p in jeng.pools.items()},
                          SubarrayAllocator(a.num_blocks, a.num_slabs,
                                            reserved_zero_per_slab=1),
                          max_requests=64, staging=dict(jeng.staging))


def scripted_flush(eng, ref_cls):
    """test_obs.py's scripted flush on either package."""
    eng.alloc.mark_written([1, 2, 3])
    s = eng.stream("scripted")
    s.memcopy([(1, 5), (2, 6)])
    s.materialize_zeros([9, 10])
    s.memcopy_cross([(ref_cls("k_stage", 2), ref_cls("k", 11))])
    return s.flush()


# ---------------------------------------------------------------------------
# metrics == journal, and the port's series == the reference's
# ---------------------------------------------------------------------------

def test_flush_metrics_match_journal_and_reference():
    """The drain counters of a scripted flush equal the journal record
    (per-opcode rows, spacers, launches), the queue counters the ticket's
    commands; every core series equals the reference's."""
    jeng, teng = both_engines()
    jt = scripted_flush(jeng, jcore.BlockRef)
    t = scripted_flush(teng, BlockRef)
    assert isinstance(t, FlushTicket) and t.commands == jt.commands == 5

    rec = teng.journal.records[-1]
    assert rec.stream == "scripted"
    want: dict = {}
    spacers = 0
    for op, _src, _dst in rec.rows:
        if op < 0:
            spacers += 1
        else:
            name = OPCODE_NAMES[int(op)]
            want[name] = want.get(name, 0) + 1
    reg = tobs.registry()
    got = {dict(labels)["opcode"]: int(v)
           for labels, v in reg.series("drain.rows").items()
           if dict(labels)["stream"] == "scripted"}
    assert got == want
    assert int(reg.get("drain.spacer_rows", stream="scripted")) == spacers
    assert int(reg.get("drain.launches", stream="scripted")) \
        == rec.launches == t.launches == 1
    enqueued = sum(v for labels, v in reg.series("queue.enqueued").items()
                   if dict(labels)["stream"] == "scripted")
    assert int(enqueued) == t.commands
    assert len(reg.hist("drain.flush_us", stream="scripted")) == 1
    assert reg.hist("drain.table_len", stream="scripted") \
        == [float(t.timing.table_len)]
    assert series_of(tobs) == series_of(jobs)
    assert table_lens(tobs) == table_lens(jobs)
    assert_same_pools(jeng, teng, "scripted flush")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_property_stream_series_match_reference(seed):
    """The dispatch property streams (WAR spacers, hazard auto-flushes,
    overflow chunks, bitwise rows) emit the same series, with the same
    padded table lengths, on both packages."""
    prog = gen_program(random.Random(seed), 16, 24)
    jeng = jax_prop_engine(16, 0, True, seed=seed)
    teng = port_engine_like(jeng)
    run_program(jeng, prog)
    run_program_port(teng, prog)
    assert series_of(tobs) == series_of(jobs)
    assert table_lens(tobs) == table_lens(jobs)
    assert sum(v for v in tobs.registry().series("drain.rows").values()) > 0
    assert_same_pools(jeng, teng, f"property stream seed={seed}")


def test_retire_and_abort_series_match_reference():
    """``retire`` counts ``queue.retired`` and disarms the residency clock
    once the queue is empty; ``abort`` disarms it too (both packages)."""
    out = []
    jeng, teng = both_engines(seed=3)
    for eng, ref_cls, m in ((jeng, jcore.BlockRef, jobs),
                            (teng, BlockRef, tobs)):
        s = eng.stream("lane")
        s.memcopy_cross([(ref_cls("k_stage", 1), ref_cls("k", 12))])
        gid = (eng.group.base("k_stage") + 1, eng.group.base("k") + 12)
        assert s.queue.retire([(OP_CROSS_POOL_COPY, *gid)]) == 1
        assert s.queue._first_enqueue_t is None
        s.memcopy_cross([(ref_cls("k_stage", 1), ref_cls("k", 12))])
        assert s.queue._first_enqueue_t is not None
        s.queue.abort()
        assert s.queue._first_enqueue_t is None
        assert s.queue.pop_residency_us() == 0.0
        out.append(series_of(m))
    assert out[1] == out[0]
    assert out[1]["queue.retired"] == {(("stream", "lane"),): 1.0}


def test_ticket_timing_field():
    """FlushTicket.timing carries the drain's timing; an empty flush has
    None, on both packages."""
    for eng, m in ((jax_obs_engine(seed=2), "jax"),
                   (port_engine_like(jax_obs_engine(seed=2)), "port")):
        eng.alloc.mark_written([4])
        s = eng.stream("timed")
        s.memcopy([(4, 9)])
        t = s.flush()
        assert t.timing is not None, m
        assert t.timing.launches == t.launches == 1
        assert t.timing.drain_us > 0.0
        assert t.timing.queue_residency_us >= 0.0
        assert t.timing.table_len == 8
        assert s.flush().timing is None, m


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _spanned(eng):
    eng.alloc.mark_written([2])
    s = eng.stream("spanned")
    with s.capture():
        eng.memcopy([(2, 7)])
    s.flush().wait()


def test_span_nesting_flush_drain_wait():
    """flush() opens a "flush" span with the "drain" span nested inside;
    wait() records "ticket-wait": the same (name, depth, parent, labels)
    sequence and tree as the reference's."""
    jeng, teng = both_engines(seed=5)
    _spanned(jeng)
    _spanned(teng)
    recs = ttrace.spans()
    assert span_shape(recs) == span_shape(jtrace.spans())
    assert [(r.name, r.depth, r.parent) for r in recs] == [
        ("flush", 0, -1), ("drain", 1, 0), ("ticket-wait", 0, -1)]
    f, d = recs[0], recs[1]
    assert d.end >= d.start and f.end >= d.end >= f.start
    assert dict(f.labels)["stream"] == "spanned"

    def names(tree):
        return [(n["name"], n["labels"], names(n["children"])) for n in tree]

    assert names(ttrace.span_tree()) == names(jtrace.span_tree())
    assert ttrace._STACK == []


def test_set_tracing_off_records_nothing():
    """Tracing off: no records, the same launches (both packages)."""
    jeng, teng = both_engines(seed=6)
    for eng, t in ((jeng, jtrace), (teng, ttrace)):
        prev = t.set_tracing(False)
        try:
            eng.alloc.mark_written([3])
            s = eng.stream("silent")
            s.memcopy([(3, 8)])
            assert s.flush().launches == 1
            assert t.spans() == []
        finally:
            t.set_tracing(prev)


def test_span_ring_reanchors_parents(monkeypatch):
    """Past MAX_SPANS the ring drops its oldest records and re-anchors
    the parent indices of those that stay (both packages)."""
    for t in (jtrace, ttrace):
        monkeypatch.setattr(t, "MAX_SPANS", 4)
        for i in range(3):
            with t.span("round", i=i):
                with t.span("drain"):
                    pass
    assert [(r.name, r.depth, r.parent) for r in ttrace.spans()] == [
        ("round", 0, -1), ("drain", 1, 0), ("round", 0, -1),
        ("drain", 1, 2)]
    assert span_shape(ttrace.spans()) == span_shape(jtrace.spans())


def test_span_ring_drops_an_open_span(monkeypatch):
    """More than MAX_SPANS records inside one open span drop its own
    record: the port keeps recording, the stack ends empty and the
    children stay roots.  The reference's exit of that span raises
    IndexError (its stack lost the entry), a divergence ROADMAP §3
    records."""
    for t in (jtrace, ttrace):
        monkeypatch.setattr(t, "MAX_SPANS", 4)
    with ttrace.span("outer"):
        for i in range(5):
            with ttrace.span("inner", i=i):
                pass
    assert ttrace._STACK == []
    assert [(r.name, r.depth, r.parent) for r in ttrace.spans()] == [
        ("inner", 1, -1)] * 4
    with pytest.raises(IndexError):
        with jtrace.span("outer"):
            for i in range(5):
                with jtrace.span("inner", i=i):
                    pass


# ---------------------------------------------------------------------------
# recovery: "replay" drains and drains that raise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    sc_launch_failure_recovers_bitwise,
    sc_midflush_abort_journals_prefix_and_redrains],
    ids=lambda f: f.__name__[3:])
def test_recovery_series_and_spans_match_reference(scenario, tmp_path):
    """A recovery scenario of tests/test_fault_recovery.py (an injected
    launch failure or a mid-flush abort, re-drained, then every pool
    killed and replayed as stream ``"replay"``) emits the same series and
    the same span records on both packages, and leaves no span open."""
    scenario(JAX, tmp_path / "jax")
    scenario(PORT, tmp_path / "port")
    got, want = series_of(tobs), series_of(jobs)
    assert got == want
    assert table_lens(tobs) == table_lens(jobs)
    assert span_shape(ttrace.spans()) == span_shape(jtrace.spans())
    assert ttrace._STACK == [] and jtrace._STACK == []
    if "midflush" in scenario.__name__:
        assert any(dict(k)["stream"] == "replay"
                   for k in got["drain.launches"])


def test_killed_pool_drain_closes_its_spans():
    """A drain a killed pool refuses raises out of the "flush" and
    "drain" spans: both records are closed and the stack is empty."""
    eng = PORT.mk_engine()
    eng.kill_pool("k")
    with pytest.raises(RuntimeError, match="no storage"):
        eng.memcopy([(0, 1)])
    assert [r.name for r in ttrace.spans()] == ["drain"]
    assert all(r.end >= r.start > 0 for r in ttrace.spans())
    assert ttrace._STACK == []
    s = eng.stream("s")
    s.memcopy_cross([(BlockRef("v", 0), BlockRef("k", 1))])
    with pytest.raises(RuntimeError, match="no storage"):
        s.flush()
    assert [r.name for r in ttrace.spans()] == ["drain", "flush", "drain"]
    assert ttrace._STACK == []


# ---------------------------------------------------------------------------
# TunedProfile
# ---------------------------------------------------------------------------

def test_profile_roundtrip_and_engine_precedence(tmp_path, monkeypatch):
    """A saved profile loads into RowCloneEngine, and ServingEngine's ring
    resolves kwarg > profile > policy: the profile's ring_capacity applies
    when max_admit_pages is omitted, an explicit kwarg wins, and no
    profile means the policy's ring."""
    monkeypatch.delenv("REPRO_NO_TUNED", raising=False)
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path))
    prof = tauto.TunedProfile(backend="cpu", buckets=(4, 16, 64, 256),
                              overlap=False, max_delta_signatures=4,
                              ring_capacity=3, us_per_flush=10.0,
                              baseline_us_per_flush=20.0,
                              swept={"flush": {"rows": []}})
    path = tauto.save_profile(prof)
    assert path == tmp_path / "cpu.json"
    assert tauto.load_profile("cpu") == prof
    assert tauto.backend_key(torch.device("cpu")) == "cpu"
    assert tauto.backend_key("cuda:0") == "cuda"

    assert port_obs_engine().profile == prof
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    model = init_params(get_config("llama3.2-3b").reduced(), 0, "cpu")
    srv = ServingEngine(model.cfg, model, max_seqs=2, max_blocks_per_seq=4,
                        device="cpu")
    assert srv.ring_capacity == 3                   # profile's ring
    assert ServingEngine(model.cfg, model, max_seqs=2, max_blocks_per_seq=4,
                         max_admit_pages=2, device="cpu").ring_capacity == 2

    monkeypatch.setenv("REPRO_NO_TUNED", "1")
    assert tauto.load_profile("cpu") is None
    eng_def = port_obs_engine()
    assert eng_def.profile is None
    assert ServingEngine(model.cfg, model, max_seqs=2, max_blocks_per_seq=4,
                         device="cpu").ring_capacity == 4   # the policy


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_profile_loads_in_the_other_package(tmp_path, monkeypatch, writer):
    """A profile one package saves, the other loads to the same fields,
    and both packages' engines load it."""
    monkeypatch.delenv("REPRO_NO_TUNED", raising=False)
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path))
    kw = dict(backend="cpu", buckets=(16, 64, 256, 1024), overlap=False,
              max_delta_signatures=16, ring_capacity=8, us_per_flush=1.5,
              baseline_us_per_flush=2.5,
              swept={"flush": {"rows": [{"cfg": {"x": 1}}]}})
    src, dst = (jauto, tauto) if writer == "jax" else (tauto, jauto)
    path = src.save_profile(src.TunedProfile(**kw))
    loaded = dst.load_profile("cpu")
    assert loaded is not None and loaded.to_dict() == \
        src.TunedProfile(**kw).to_dict()
    # the two packages write the same file for the same profile
    other = dst.save_profile(dst.TunedProfile(**kw), tmp_path / "other")
    assert other.read_text() == path.read_text()
    assert jax_obs_engine().overlap is False
    assert port_obs_engine().profile == tauto.load_profile("cpu")


def test_profile_malformed_file_degrades_to_none(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_NO_TUNED", raising=False)
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path))
    (tmp_path / "cpu.json").write_text("{not json")
    assert tauto.load_profile("cpu") is None
    assert jauto.load_profile() is None
    (tmp_path / "cpu.json").write_text('{"backend": "cpu", "buckets": "x"}')
    assert tauto.load_profile("cpu") is None


def test_pick_winner_margin_rule():
    """A candidate unseats the default only past the 3% margin; the
    default's absence is an error.  Same winners as the reference's."""
    rows = [{"cfg": {"x": 0}, "us_per_flush": 100.0},
            {"cfg": {"x": 1}, "us_per_flush": 98.0}]
    for pw in (tauto.pick_winner, jauto.pick_winner):
        assert pw(rows, {"x": 0})["cfg"] == {"x": 0}     # 2% < margin
    rows[1]["us_per_flush"] = 90.0
    for pw in (tauto.pick_winner, jauto.pick_winner):
        assert pw(rows, {"x": 0})["cfg"] == {"x": 1}     # 10% > margin
        with pytest.raises(ValueError):
            pw(rows, {"x": 99})
        with pytest.raises(ValueError):
            pw([], {"x": 0})


def test_buckets_setter_matches_reference():
    """set_buckets / get_buckets: validation, restore on None, and a
    flush under a retargeted set pads to the same tables on both."""
    from repro.core import cmdqueue as jcmdqueue
    assert tcmdqueue.DEFAULT_BUCKETS == jcmdqueue.DEFAULT_BUCKETS
    for bad in ((), (8, 8), (0, 4), (32, 8)):
        with pytest.raises(ValueError):
            tcmdqueue.set_buckets(bad)
    try:
        for cq in (tcmdqueue, jcmdqueue):
            assert cq.set_buckets([4, 16]) == (4, 16)
            assert cq.bucket_size(5) == 16 and cq.top_bucket() == 16
        jeng, teng = both_engines(seed=7)
        for eng in (jeng, teng):
            eng.alloc.mark_written(list(range(1, 8)))
            eng.memcopy([(i, 16 + i) for i in range(1, 8)])
            eng.memcopy([(i, 24 + i) for i in range(1, 3)])
        assert table_lens(tobs) == table_lens(jobs)
        assert sorted(table_lens(tobs)[("drain.table_len",
                                        (("stream", "default"),))]) \
            == [4.0, 16.0]
        assert_same_pools(jeng, teng, "retargeted buckets")
    finally:
        jcmdqueue.set_buckets(None)
        tcmdqueue.set_buckets(None)
    assert tcmdqueue.get_buckets() == tcmdqueue.DEFAULT_BUCKETS


def test_autotune_quick_writes_loadable_profile(tmp_path, monkeypatch):
    """launch/autotune.py's quick sweep on the CPU writes a profile that
    load_profile reads back, with the baseline measured, 1.0 launches a
    flush under every swept bucket set, the unswept axes recorded, and
    the default buckets restored."""
    monkeypatch.delenv("REPRO_NO_TUNED", raising=False)
    prof = tlaunch_autotune.tune(out_dir=str(tmp_path), quick=True,
                                 skip_ring=True, device="cpu")
    assert (tmp_path / "cpu.json").is_file()
    assert tauto.load_profile("cpu", directory=str(tmp_path)) == prof
    assert jauto.load_profile("cpu", directory=str(tmp_path)).buckets \
        == prof.buckets
    assert prof.baseline_us_per_flush > 0.0
    assert prof.us_per_flush <= prof.baseline_us_per_flush
    rows = prof.swept["flush"]["rows"]
    assert [r["cfg"]["buckets"] for r in rows] == [
        list(b) for b in tlaunch_autotune.BUCKET_SETS[:2]]
    assert all(r["launches_per_flush"] == 1.0 for r in rows)
    assert "not swept" in prof.swept["flush"]["overlap"]
    assert "not swept" in prof.swept["delta_signatures"]["note"]
    assert tcmdqueue.get_buckets() == tcmdqueue.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# metrics-on vs metrics-off: bitwise parity
# ---------------------------------------------------------------------------

def test_metrics_on_off_pools_bitwise_identical():
    """The same script with metrics and tracing on or off gives the same
    pool bytes and launches, equal to the JAX engine's; off emits and
    records nothing."""
    script = _scripted_rounds(np.random.default_rng(11), nblk=32)

    def run(eng, flag):
        prev_m = tobs.set_metrics_enabled(flag)
        prev_t = ttrace.set_tracing(flag)
        try:
            eng.alloc.mark_written([1, 2, 3])
            s = eng.stream("prop")
            launches = []
            for pairs, zeros, stage, promote in script:
                s.memcopy(pairs)
                s.materialize_zeros(zeros)
                s.memcopy_cross([(BlockRef("k_stage", stage),
                                  BlockRef("k", promote))])
                launches.append(s.flush().launches)
            return {n: bits(p) for n, p in eng.pools.items()}, launches
        finally:
            tobs.set_metrics_enabled(prev_m)
            ttrace.set_tracing(prev_t)

    jeng = jax_obs_engine(seed=9)
    pools_on, launches_on = run(port_engine_like(jeng), True)
    tobs.registry().reset()
    ttrace.reset_spans()
    pools_off, launches_off = run(port_engine_like(jeng), False)
    assert tobs.registry().counters == {} and tobs.registry().hists == {}
    assert ttrace.spans() == []
    assert launches_on == launches_off
    for name in pools_on:
        np.testing.assert_array_equal(pools_on[name], pools_off[name])
    jeng.alloc.mark_written([1, 2, 3])
    s = jeng.stream("prop")
    launches_jax = []
    for pairs, zeros, stage, promote in script:
        s.memcopy(pairs)
        s.materialize_zeros(zeros)
        s.memcopy_cross([(jcore.BlockRef("k_stage", stage),
                          jcore.BlockRef("k", promote))])
        launches_jax.append(s.flush().launches)
    jax.block_until_ready(list(jeng.pools.values()))
    assert launches_on == launches_jax
    for name in pools_on:
        np.testing.assert_array_equal(pools_on[name], bits(jeng.pools[name]))
