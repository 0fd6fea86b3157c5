"""The port's recovery path against the JAX package's, on the same inputs:
journal replay, ``snapshot`` / ``recover``, ``FaultPlan``, the checkpoint
manager and stream, and ``ServingEngine``'s ``fault_plan`` /
``auto_recover`` / ``ckpt_*``.

* every scenario of ``tests/test_fault_recovery.py`` runs on both engines,
  keeps the reference test's own assertions on each, and compares the pools
  by bits (uint8 views), the journal records, the ``RecoveryReport``
  fields and ``fired``;
* a checkpoint one package writes is one the other restores, bitwise;
* a serving fault leg on the reduced llama3.2-3b (the JAX weights carried
  across by ``from_jax_params``): greedy tokens, ``evicted_sids``,
  ``fired``, the recovery reports and the degraded ring capacity equal the
  JAX engine's, and each engine's tokens equal its clean twin's;
* K1's wrapper refuses a killed pool before it touches any pool.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fault_recovery import mk_engine as jax_mk_engine
from test_torch_contract import bits
from test_torch_serve import LOGIT_ATOL

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.kernels.fused_dispatch as jfd
import repro.launch.serve as jserve
import repro.runtime.fault as jfault
import repro_torch.checkpoint as tckpt
import repro_torch.core.journal as tjournal
import repro_torch.core.poolspec as tps
import repro_torch.kernels.fused_dispatch as tfd
import repro_torch.runtime.fault as tfault
from repro.configs import get_config as jget_config
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pool_dead
from repro_torch.launch.serve import ServingEngine
from repro_torch.weights import from_jax_params

pytestmark = pytest.mark.fault


def port_mk_engine(nblk=32, spill_nblk=0, stage_nblk=0, nslabs=4):
    """``test_fault_recovery.mk_engine`` in the port: the same pool bytes,
    pool group and allocator, ZI off."""
    blk = (4, 8)
    n = int(np.prod(blk))
    pools = {
        "k": torch.arange(nblk * n, dtype=torch.float32).reshape(
            (nblk,) + blk),
        "v": -torch.arange(nblk * n, dtype=torch.float32).reshape(
            (nblk,) + blk),
    }
    specs = [tps.PoolSpec("k", nblk, blk, torch.float32),
             tps.PoolSpec("v", nblk, blk, torch.float32)]
    if stage_nblk:
        for pn in ("k", "v"):
            pools[f"{pn}_stage"] = torch.full((stage_nblk,) + blk, 7.0)
            specs.append(tps.PoolSpec(f"{pn}_stage", stage_nblk, blk,
                                      torch.float32, role="staging",
                                      paired=pn))
    if spill_nblk:
        for pn in ("k", "v"):
            pools[f"{pn}_spill"] = torch.zeros((spill_nblk,) + blk)
            specs.append(tps.PoolSpec(f"{pn}_spill", spill_nblk, blk,
                                      torch.float32, role="spill",
                                      paired=pn))
    return RowCloneEngine(pools, SubarrayAllocator(nblk, nslabs),
                          group=tps.PoolGroup(specs), enable_zi=False)


def _jax_kill(eng, name):
    eng.pools[name].delete()


def _port_kill(eng, name):
    eng.kill_pool(name)


#: each package's names, as the scenarios use them
JAX = types.SimpleNamespace(
    name="jax", mk_engine=jax_mk_engine, kill=_jax_kill,
    FaultPlan=jfault.FaultPlan, InjectedFault=jfault.InjectedFault,
    PoolSnapshot=jcore.PoolSnapshot, RecoveryError=jcore.RecoveryError,
    TicketJournal=jcore.TicketJournal, BlockRef=jcore.BlockRef,
    CheckpointManager=jckpt.CheckpointManager,
    PoolCheckpoint=jckpt.PoolCheckpoint, fd=jfd,
    block=lambda eng, name, b: np.asarray(eng.pools[name][b]))
PORT = types.SimpleNamespace(
    name="port", mk_engine=port_mk_engine, kill=_port_kill,
    FaultPlan=tfault.FaultPlan, InjectedFault=tfault.InjectedFault,
    PoolSnapshot=tjournal.PoolSnapshot, RecoveryError=tjournal.RecoveryError,
    TicketJournal=tjournal.TicketJournal, BlockRef=tps.BlockRef,
    CheckpointManager=tckpt.CheckpointManager,
    PoolCheckpoint=tckpt.PoolCheckpoint, fd=tfd,
    block=lambda eng, name, b: eng.pools[name][b].clone().numpy())


def pools_of(eng):
    """Every pool as host bytes (uint8), for a bitwise comparison (of a
    copy: a CPU pool that numpy shares can no longer be killed)."""
    return {n: bits(p.clone()) if isinstance(p, torch.Tensor)
            else bits(np.asarray(p)) for n, p in eng.pools.items()}


def snap_arrays(eng):
    """Host copies of every pool in the package's own snapshot format."""
    if isinstance(next(iter(eng.pools.values())), torch.Tensor):
        return eng.snapshot().arrays
    return {n: np.asarray(p) for n, p in eng.pools.items()}


def assert_same(a, b, what):
    assert sorted(a) == sorted(b), what
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=f"{what}: {n}")


def records(eng):
    return [(r.stream, r.index, tuple(tuple(x) for x in r.rows), r.launches,
             r.war_hazards, r.spacer_rows, r.aborted, r.plan_sig)
            for r in eng.journal.records]


def report(rep):
    return dataclasses.asdict(rep)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_fault_recovery.py, on either package: each
# returns the observables to compare, in order
# ---------------------------------------------------------------------------

def sc_journal_records_flushes(P, tmp):
    eng = P.mk_engine()
    eng.memcopy([(0, 1)])
    s = eng.stream("aux")
    s.memcopy([(2, 3), (4, 5)])
    t = s.flush()
    recs = eng.journal.records
    assert [r.index for r in recs] == [0, 1]
    assert recs[0].stream == "default" and recs[1].stream == "aux"
    assert recs[1].rows == ((0, 2, 3), (0, 4, 5))
    assert recs[1].launches == t.launches == 1
    assert eng.journal.head_index == 0
    assert eng.journal.last_index == t.index == 1
    return [records(eng), eng.journal.head_index, eng.journal.last_index,
            [r.index for r in eng.journal.since(0)], pools_of(eng)]


def sc_journal_ring_bounds_capacity(P, tmp):
    eng = P.mk_engine()
    eng.journal = P.TicketJournal(capacity=4)
    for _ in range(8):
        eng.memcopy([(0, 1)])
    assert len(eng.journal) == 4 and eng.journal.head_index == 4
    return [records(eng), eng.journal.head_index, pools_of(eng)]


def sc_launch_failure_recovers_bitwise(P, tmp):
    clean, eng = P.mk_engine(), P.mk_engine()
    eng.memcopy([(0, 1)])
    clean.memcopy([(0, 1)])
    plan = P.FaultPlan(launch_failures=(eng.next_flush_index,))
    with plan.active(eng):
        with pytest.raises(P.InjectedFault):
            eng.memcopy([(2, 3), (4, 5)])
    assert plan.fired == [("launch_failure", 1)]
    assert len(eng._aborted) == 1
    stash = eng._aborted[0]
    assert stash.suffix == ((0, 2, 3), (0, 4, 5))
    rep = eng.recover()
    assert rep.redrained_flushes == 1 and rep.retries == 0
    clean.memcopy([(2, 3), (4, 5)])
    assert_same(pools_of(eng), pools_of(clean), "vs clean twin")
    assert not any(r.aborted for r in eng.journal.records)
    return [plan.fired, (stash.queue, stash.index, stash.rows, stash.suffix),
            report(rep), records(eng), pools_of(eng)]


def _snapshot_replay(P, eng, init):
    """Kill every pool, recover from the pre-history snapshot ``init``:
    replay of the whole journal must land the same bytes."""
    want = pools_of(eng)
    for name in list(eng.pools):
        P.kill(eng, name)
    rep = eng.recover(snapshot=P.PoolSnapshot(index=-1, arrays=init))
    assert set(rep.pools_restored) == set(init) and not rep.pools_lost
    assert rep.replayed_flushes == len(eng.journal.records) == 2
    assert_same(pools_of(eng), want, "after snapshot + replay")
    return report(rep)


def sc_midflush_abort_journals_prefix_and_redrains(P, tmp):
    nblk = 2048
    pairs = [(2 * i, 2 * i + 1) for i in range(600)]
    clean, eng = P.mk_engine(nblk=nblk), P.mk_engine(nblk=nblk)
    init = snap_arrays(eng)
    plan = P.FaultPlan(midflush_aborts=(eng.next_flush_index,))
    with plan.active(eng):
        with pytest.raises(P.InjectedFault):
            eng.memcopy(pairs)
    assert plan.fired == [("midflush_abort", 0)]
    assert eng.journal.records[-1].aborted
    assert len(eng.journal.records[-1].rows) == 512
    assert len(eng._aborted[0].suffix) == 600 - 512
    prefix = records(eng)
    rep = eng.recover()
    assert rep.redrained_flushes == 1
    clean.memcopy(pairs)
    assert_same(pools_of(eng), pools_of(clean), "vs clean twin")
    after = pools_of(eng)
    rep2 = _snapshot_replay(P, eng, init)
    return [plan.fired, prefix, report(rep), records(eng), after, rep2,
            pools_of(eng)]


def sc_midflush_abort_with_compute_rows(P, tmp):
    nblk = 2048
    copies = [(i, 1000 + i) for i in range(200)]
    ands = [(200 + i, 400 + i, 1200 + i) for i in range(200)]
    nots = [(600 + i, 1400 + i) for i in range(100)]

    def drive(eng):
        eng.alloc.mark_written([s for s, _ in copies] +
                               [a for a, _, _ in ands] +
                               [b for _, b, _ in ands] +
                               [s for s, _ in nots])
        with eng.batch():
            eng.memcopy(copies)
            eng.memand(ands)
            eng.memnot(nots)

    clean, eng = P.mk_engine(nblk=nblk), P.mk_engine(nblk=nblk)
    init = snap_arrays(eng)
    plan = P.FaultPlan(midflush_aborts=(eng.next_flush_index,))
    with plan.active(eng):
        with pytest.raises(P.InjectedFault):
            drive(eng)
    assert eng.journal.records[-1].aborted
    assert len(eng.journal.records[-1].rows) == 512
    assert len(eng._aborted[0].suffix) == 800 - 512
    rep = eng.recover()
    assert rep.redrained_flushes == 1
    drive(clean)
    assert_same(pools_of(eng), pools_of(clean), "vs clean twin")
    after = pools_of(eng)
    rep2 = _snapshot_replay(P, eng, init)
    return [plan.fired, report(rep), records(eng), after, rep2,
            pools_of(eng)]


def sc_launch_failure_on_bitwise_flush(P, tmp):
    clean, eng = P.mk_engine(), P.mk_engine()
    for e in (clean, eng):
        e.alloc.mark_written([1, 2, 3])

    def drive(e):
        with e.batch():
            e.memand([(1, 2, 8)])
            e.memor([(2, 3, 9)])
            e.memnot([(3, 10)])

    plan = P.FaultPlan(launch_failures=(eng.next_flush_index,))
    with plan.active(eng):
        with pytest.raises(P.InjectedFault):
            drive(eng)
    assert plan.fired == [("launch_failure", 0)]
    rep = eng.recover()
    assert rep.redrained_flushes == 1
    drive(clean)
    assert_same(pools_of(eng), pools_of(clean), "vs clean twin")
    return [plan.fired, report(rep), records(eng), pools_of(eng)]


def sc_redrain_retries_with_backoff(P, tmp):
    eng = P.mk_engine()
    fails = {"n": 3}                 # the abort + 2 failed retries

    def flaky(info):
        if info.engine is eng and fails["n"] > 0:
            fails["n"] -= 1
            raise P.InjectedFault("flaky")

    P.fd.add_drain_guard(flaky)
    try:
        with pytest.raises(P.InjectedFault):
            eng.memcopy([(0, 1)])
        rep = eng.recover(max_retries=3, backoff=0.001)
    finally:
        P.fd.remove_drain_guard(flaky)
    assert rep.retries == 2 and rep.redrained_flushes == 1
    np.testing.assert_array_equal(P.block(eng, "k", 1), P.block(eng, "k", 0))
    return [report(rep), records(eng), eng.next_flush_index, pools_of(eng)]


def sc_redrain_exhaustion_raises(P, tmp):
    eng = P.mk_engine()

    def always(info):
        if info.engine is eng:
            raise P.InjectedFault("always")

    P.fd.add_drain_guard(always)
    try:
        with pytest.raises(P.InjectedFault):
            eng.memcopy([(0, 1)])
        with pytest.raises(P.RecoveryError) as err:
            eng.recover(max_retries=2, backoff=0.001)
    finally:
        P.fd.remove_drain_guard(always)
    return [str(err.value), eng._aborted, records(eng),
            eng.next_flush_index, pools_of(eng)]


def sc_fault_plan_binds_to_one_engine(P, tmp):
    a, b = P.mk_engine(), P.mk_engine()
    plan = P.FaultPlan(launch_failures=(0,))
    with plan.active(a):
        b.memcopy([(0, 1)])
        with pytest.raises(P.InjectedFault):
            a.memcopy([(0, 1)])
    assert plan.fired == [("launch_failure", 0)]
    rep = a.recover()
    assert_same(pools_of(a), pools_of(b), "a vs b")
    return [plan.fired, report(rep), records(a), records(b), pools_of(a)]


def sc_recover_evicts_queued_promotions(P, tmp):
    eng = P.mk_engine(stage_nblk=4)
    slots = eng.stage_blocks(2)
    s = eng.stream("serve")
    s.promote_staged(list(zip(slots, [0, 1])))
    assert len(s.queue) == 4
    for name in eng.staging:
        P.kill(eng, name)
    rep = eng.recover()
    assert rep.evicted_promotions == 4
    assert set(rep.pools_lost) == {"k_stage", "v_stage"}
    assert len(s.queue) == 0
    assert len(eng._stage_free) == eng.stage_capacity == 4
    return [slots, report(rep), list(eng._stage_free), records(eng),
            pools_of(eng)]


def sc_ticket_wait_scoped(P, tmp):
    eng = P.mk_engine(spill_nblk=4)
    BR = P.BlockRef
    ck = eng.stream("ckpt")
    ck.memcopy_cross([(BR("k", 0), BR("k_spill", 0)),
                      (BR("v", 0), BR("v_spill", 0))])
    t = ck.flush()
    assert t.touched == ("k_spill", "v_spill")
    want = P.block(eng, "k", 0)
    P.kill(eng, "k")
    P.kill(eng, "v")
    assert t.expired
    t.wait()
    got = t.block_state(BR("k_spill", 0))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="expired"):
        t.block_state(BR("k", 0))
    return [t.touched, t.expired, t.index, t.launches, bits(got)]


def sc_pool_checkpoint_quiesced_roundtrip(P, tmp):
    eng = P.mk_engine(nblk=16, spill_nblk=8)
    pc = P.PoolCheckpoint(eng, P.CheckpointManager(str(tmp)), window=8)
    eng.memcopy([(0, 3)])
    want = {n: pools_of(eng)[n] for n in ("k", "v")}
    pc.drain()
    assert pc.passes == 1
    snap = pc.latest()
    assert snap is not None and sorted(snap.arrays) == ["k", "v"]
    assert_same({n: bits(snap.arrays[n]) for n in ("k", "v")}, want,
                "persisted pass")
    assert snap.index == eng.journal.last_index
    eng.memcopy([(3, 5)])
    want2 = {n: pools_of(eng)[n] for n in ("k", "v")}
    P.kill(eng, "k")
    P.kill(eng, "v")
    rep = eng.recover(snapshot=snap)
    assert set(rep.pools_restored) == {"k", "v"}
    assert rep.replayed_flushes == 1
    got = {n: pools_of(eng)[n] for n in ("k", "v")}
    assert_same(got, want2, "restored")
    return [snap.index, report(rep), records(eng), pools_of(eng)]


def sc_pool_checkpoint_requires_spill(P, tmp):
    eng = P.mk_engine()
    with pytest.raises(ValueError, match="spill") as err:
        P.PoolCheckpoint(eng, P.CheckpointManager(str(tmp)))
    return [str(err.value)]


SCENARIOS = [sc_journal_records_flushes, sc_journal_ring_bounds_capacity,
             sc_launch_failure_recovers_bitwise,
             sc_midflush_abort_journals_prefix_and_redrains,
             sc_midflush_abort_with_compute_rows,
             sc_launch_failure_on_bitwise_flush,
             sc_redrain_retries_with_backoff, sc_redrain_exhaustion_raises,
             sc_fault_plan_binds_to_one_engine,
             sc_recover_evicts_queued_promotions, sc_ticket_wait_scoped,
             sc_pool_checkpoint_quiesced_roundtrip,
             sc_pool_checkpoint_requires_spill]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scenario_matches_reference(scenario, tmp_path):
    """One scenario of tests/test_fault_recovery.py on both engines: the
    reference test's assertions hold on each, and every observable (pool
    bits, journal records, reports, fired, stashes) is equal."""
    want = scenario(JAX, tmp_path / "jax")
    got = scenario(PORT, tmp_path / "port")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, dict) and w and all(
                isinstance(x, np.ndarray) for x in w.values()):
            assert_same(g, w, f"observable {i}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"observable {i}")
        else:
            assert g == w, f"observable {i}"


def test_replay_refuses_a_bad_row():
    """Replay checks every record against the opcode registry before
    anything re-drains: a corrupted row raises RecoveryError and no pool
    changes (as the reference's)."""
    for P in (JAX, PORT):
        eng = P.mk_engine()
        eng.memcopy([(0, 1)])
        eng.memcopy([(2, 3)])
        rec = eng.journal.records[-1]
        eng.journal.append(dataclasses.replace(
            rec, index=rec.index + 1, rows=((99, 2, 3),)))
        before = pools_of(eng)
        with pytest.raises(P.RecoveryError, match="opcode contract"):
            eng.journal.replay(eng, after=-1)
        assert_same(pools_of(eng), before, P.name)


# ---------------------------------------------------------------------------
# the checkpoint manager: one package writes, the other restores
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"pools": {"v": rng.standard_normal((3, 4)).astype(np.float32),
                      "k": rng.integers(0, 2 ** 16, (2, 5)).astype(
                          np.uint16)},
            "index": np.asarray(7, np.int64),
            "opt": (rng.standard_normal(6).astype(np.float32), None,
                    [np.arange(4, dtype=np.int32)])}


def test_checkpoint_cross_load(tmp_path):
    """The same tree saved by one package restores in the other bitwise:
    the npz keys follow the JAX flatten order and the manifests agree."""
    import json
    tree = _tree(np.random.default_rng(0))
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), async_save=False)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    jm.save(3, tree)
    tm.save(3, tree)
    tm.wait()
    for d in ("j", "t"):
        assert sorted((tmp_path / d).iterdir())[0].name == "step_3"
    mj = json.loads((tmp_path / "j/step_3/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_3/manifest.json").read_text())
    for key in ("step", "keys", "shapes", "dtypes"):
        assert mt[key] == mj[key], key
    got_t, step_t = tckpt.CheckpointManager(str(tmp_path / "j")).restore(
        tree)
    got_j, step_j = jckpt.CheckpointManager(str(tmp_path / "t")).restore(
        tree)
    assert step_t == step_j == 3
    want = jax.tree_util.tree_leaves(tree)
    for got in (got_t, got_j):
        leaves = jax.tree_util.tree_leaves(got)
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(bits(np.asarray(a)), bits(b))
    assert got_t["opt"][1] is None and isinstance(got_t["opt"], tuple)


def test_checkpoint_bf16_cross_load(tmp_path):
    """A bfloat16 pool: the reference saves its ml_dtypes array, the port
    restores it into a bfloat16 tensor bit for bit, and the port's uint16
    bits restore in the reference bit for bit too; keep / gc and the
    save-time copy hold."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 3, 4)), jnp.bfloat16)
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), async_save=False)
    jm.save(0, {"pool": x})
    t_ex = {"pool": torch.zeros((2, 3, 4), dtype=torch.bfloat16)}
    got, _ = tckpt.CheckpointManager(str(tmp_path / "j")).restore(t_ex)
    assert got["pool"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got["pool"]), bits(np.asarray(x)))
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), keep=2)
    t = got["pool"].clone()
    saved = []
    for step in range(4):
        tm.save(step, {"pool": t})
        saved.append(t.clone())
        t.add_(1)                    # mutated after save: not in the file
    tm.wait()
    assert tm.steps() == [2, 3]
    back, _ = jckpt.CheckpointManager(str(tmp_path / "t")).restore(
        {"pool": np.zeros((2, 3, 4), np.uint16)}, step=2)
    want = saved[2].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(np.asarray(back["pool"]), want)


# ---------------------------------------------------------------------------
# the restart loop and the heartbeat ledger
# ---------------------------------------------------------------------------

def test_run_with_restarts_matches_reference(tmp_path):
    """``run_with_restarts`` on both packages: two NodeFailures, each
    after a checkpoint, then success from the latest step; and giving up
    past ``max_restarts``."""
    out = []
    for fault, ckpt in ((jfault, jckpt), (tfault, tckpt)):
        mgr = ckpt.CheckpointManager(str(tmp_path / fault.__name__),
                                     async_save=False)
        calls = []

        def loop(start, state):
            calls.append((start, float(np.asarray(state["x"]))))
            if len(calls) < 3:
                mgr.save(len(calls) * 10,
                         {"x": np.float32(len(calls))})
                raise fault.NodeFailure("boom")
            return ("done", start)

        result = fault.run_with_restarts(
            loop, {"x": np.float32(0)}, mgr, fault.RestartPolicy(5))

        def always(start, state):
            raise fault.NodeFailure("always")

        with pytest.raises(RuntimeError, match="restarts"):
            fault.run_with_restarts(always, {}, mgr, fault.RestartPolicy(2))
        out.append((result, calls))
    assert out[1] == out[0] == (("done", 20), [(0, 0.0), (10, 1.0),
                                               (20, 2.0)])


def test_heartbeat_ledger_matches_reference(monkeypatch):
    """Both ledgers, driven by the same clock: the same step times and
    the same straggler report, and ``step_end`` without ``step_start``
    records nothing."""
    clock = {"t": 0.0}
    ledgers = []
    for fault in (jfault, tfault):
        clock["t"] = 0.0
        monkeypatch.setattr(fault.obs_metrics, "now", lambda: clock["t"])
        ledger = fault.HeartbeatLedger(window=20, threshold=2.0)
        assert ledger.step_end(0) is None and ledger.times == []
        reports = []
        for step, dt in enumerate([0.01] * 8 + [0.08, 0.01]):
            ledger.step_start()
            clock["t"] += dt
            reports.append(ledger.step_end(step))
        ledgers.append((ledger.times,
                        [r and dataclasses.astuple(r) for r in reports]))
    assert ledgers[1] == ledgers[0]
    assert ledgers[0][1][8] is not None and ledgers[0][1][8][3] > 2.0


# ---------------------------------------------------------------------------
# K1's wrapper on a killed pool
# ---------------------------------------------------------------------------

def test_k1_wrapper_refuses_a_dead_pool():
    """``ops.fused_dispatch`` (the plain version here) raises on a pool
    whose storage was freed, before it writes any pool; the engine journals
    nothing and stashes the flush for recover(), which resurrects the pool
    as zeros and re-drains the stash."""
    eng = port_mk_engine()
    eng.alloc.mark_written([0, 2])
    eng.kill_pool("v")
    assert pool_dead(eng.pools["v"]) and not pool_dead(eng.pools["k"])
    k_before = eng.pools["k"].clone()
    zero = eng._get_zero_blocks()
    with pytest.raises(RuntimeError, match="no storage"):
        ops.fused_dispatch(tuple(eng.pools.values()), zero,
                           np.array([[0, 0, 1]], np.int32))
    assert torch.equal(eng.pools["k"], k_before)
    with pytest.raises(RuntimeError, match="no storage"):
        eng.memcopy([(2, 3)])
    assert torch.equal(eng.pools["k"], k_before)
    assert eng.journal.records == () and len(eng._aborted) == 1
    rep = eng.recover()
    assert rep.pools_lost == ("v",) and rep.redrained_flushes == 1
    assert torch.equal(eng.pools["k"][3], k_before[2])
    assert not eng.pools["v"].any()


def test_host_copies_round_trip_bf16():
    """``to_host`` / ``from_host``: bfloat16 as uint16 bits, NaN payloads
    kept, and ``snapshot()`` in that format."""
    t = torch.tensor([1.5, -2.0, float("inf")], dtype=torch.bfloat16)
    t = torch.cat([t, torch.tensor([0x7fc1, 0xffa3 - 0x10000], dtype=torch.int16)
                   .view(torch.bfloat16)])
    h = tjournal.to_host(t)
    assert h.dtype == np.uint16
    back = tjournal.from_host(h, torch.bfloat16, "cpu")
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    assert tjournal.host_dtype(torch.float32) == np.float32


# ---------------------------------------------------------------------------
# ServingEngine: the fault leg against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("llama3.2-3b").reduced()
    params, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config("llama3.2-3b").reduced()
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             cfg, device="cpu")
    return jcfg, params, cfg, tmodel


def _serve(served, port, **kw):
    jcfg, params, cfg, tmodel = served
    if port:
        return ServingEngine(cfg, tmodel, max_seqs=8, device="cpu", **kw)
    return jserve.ServingEngine(jcfg, params, max_seqs=8, **kw)


#: the bench's fault leg (benchmarks/bench_dispatch.py
#: _drive_fault_rounds) and the reference test's
LEGS = {"bench": dict(prompt=24, rounds=6, blocks=16),
        "test": dict(prompt=16, rounds=5, blocks=8)}


def _margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top2[1] - top2[0])


def _drive(eng, prompts, rounds, plan, fault_cls):
    """Admit two prompts, then ``rounds`` rounds: a launch failure on the
    next drain of round 1, and at round 3 a donation error on the third
    admission, re-admitted.  Returns tokens in admission order, the
    top-1 / top-2 logit margin behind each generated token, the serve
    flush's launches a round (-1: failed and recovered) and the
    recoveries' reports."""
    order, launches, reports = [], [], []
    margins = {}
    for p in prompts[:2]:
        order.append(eng.add_request(p))
    for r in range(rounds):
        if r == 1 and plan is not None:
            plan.launch_failures += (eng.engine.next_flush_index,)
        if r == 3:
            if plan is not None:
                plan.donation_errors += (eng._admission_ordinal,)
                with pytest.raises(fault_cls):
                    eng.add_request(prompts[2])
                assert len(eng.evicted_sids) == 1
                reports.append(report(eng.last_recovery))
            order.append(eng.add_request(prompts[2]))
        for sid in eng.cache.seqs:
            margins.setdefault(sid, []).append(_margin(eng.last_logits[sid]))
        eng.decode_round()
        t = eng.last_ticket
        launches.append(int(t.launches) if t is not None else -1)
        if t is None:
            reports.append(report(eng.last_recovery))
    return ([eng.tokens[s] for s in order if s in eng.tokens],
            [margins[s] for s in order if s in eng.tokens], launches,
            reports)


def _guarded(tokens, margins, prompt_len):
    """Each sequence's tokens up to its first greedy step decided by a
    top-1 / top-2 margin within twice the logit tolerance (a near-tie the
    two packages' floats may break either way), and the steps cut."""
    out, cut = [], []
    for toks, ms in zip(tokens, margins):
        n = next((i for i, m in enumerate(ms) if m <= 2 * LOGIT_ATOL),
                 len(ms))
        out.append(toks[:prompt_len + n])
        if n < len(ms):
            cut.append((len(out) - 1, n, ms[n]))
    return out, cut


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_serving_fault_leg_matches_reference(served, tmp_path, leg):
    """The fault leg with ``auto_recover`` and the checkpoint stream on
    both engines.  Each engine's tokens equal its clean twin's, bitwise.
    The port's launches a round, fired, evicted_sids, recovery reports,
    checkpoint cursor and staging ring equal the JAX engine's, and its
    greedy tokens equal the JAX engine's up to a step decided by a
    near-tie (top-1 / top-2 margin within 2 x LOGIT_ATOL on the JAX
    engine: the bench leg's sequence 0 meets one at its fifth token)."""
    c = LEGS[leg]
    vocab = served[0].vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=c["prompt"]).astype(np.int32)
               for _ in range(3)]
    out, toks, margins = {}, {}, None
    for port, pkg in ((False, jfault), (True, tfault)):
        tag = "port" if port else "jax"

        def mk(plan, sub):
            return _serve(served, port, max_blocks_per_seq=c["blocks"],
                          fault_plan=plan, auto_recover=plan is not None,
                          ckpt_pages=8, ckpt_dir=str(tmp_path / tag / sub))

        clean = _drive(mk(None, "clean"), prompts, c["rounds"], None, None)
        plan = pkg.FaultPlan()
        eng = mk(plan, "fault")
        got = _drive(eng, prompts, c["rounds"], plan, pkg.InjectedFault)
        assert got[0] == clean[0], tag          # bitwise vs the clean twin
        assert [k for k, _ in plan.fired] == ["launch_failure",
                                              "donation_error"]
        launches = got[2]
        rounds_to_recover = next(
            (i for i, n in enumerate(launches[1:]) if 0 <= n <= 1),
            len(launches))
        assert rounds_to_recover <= 2 and max(launches[2:]) <= 1
        ck = eng.pool_ckpt
        assert ck._cursor > 0 or ck.passes > 0
        toks[tag] = got[0]
        if not port:
            margins = got[1]
        out[tag] = (got[2], got[3], clean[2], plan.fired,
                    list(eng.evicted_sids), ck._cursor, ck.passes,
                    eng.engine.stage_capacity, len(eng.engine._stage_free),
                    eng.engine.stage_limit)
    for i, (g, w) in enumerate(zip(out["port"], out["jax"])):
        assert g == w, f"observable {i}"
    want, cut = _guarded(toks["jax"], margins, c["prompt"])
    got, _ = _guarded(toks["port"], margins, c["prompt"])
    assert got == want, f"tokens (near-ties cut: {cut})"
    # the guard leaves most of the leg compared
    assert sum(len(t) - c["prompt"] for t in want) >= c["rounds"] + 3


def test_serving_double_buffer_degrades_on_dead_ring(served):
    """A donation error that kills a double-buffered staging ring brings
    it back at single-buffer capacity on both engines; the evicted
    admission re-admits through the degraded ring, the sticky cap holds
    the adaptive ring's regrowth, and tokens match."""
    out = {}
    for port, pkg in ((False, jfault), (True, tfault)):
        plan = pkg.FaultPlan(donation_errors=(0,))
        eng = _serve(served, port, max_blocks_per_seq=8, double_buffer=True,
                     max_admit_pages=8, fault_plan=plan, auto_recover=True)
        assert eng.engine.stage_capacity == 16
        p = np.random.default_rng(1).integers(
            2, served[0].vocab_size, size=16).astype(np.int32)
        with pytest.raises(pkg.InjectedFault):
            eng.add_request(p)
        rep = eng.last_recovery
        assert rep is not None and rep.degraded
        assert len(eng.engine._stage_free) == eng.ring_capacity == 8
        sid = eng.add_request(p)
        toks = eng.decode_round()
        assert sid in toks
        out["port" if port else "jax"] = (
            report(rep), plan.fired, list(eng.evicted_sids), toks,
            eng.engine._stage_degraded_cap, eng.engine.stage_limit,
            len(eng.engine._stage_free))
    assert out["port"] == out["jax"]


def test_serving_recover_without_fault_plan(served, tmp_path):
    """``recover()`` by hand on a port engine whose K/V pools are killed
    between rounds: the latest checkpoint pass restores them, the queued
    round's rows evict, and the engine serves on (the ckpt arguments
    build: no ``NotImplementedError``)."""
    eng = _serve(served, True, max_blocks_per_seq=4, ckpt_pages=8,
                 ckpt_window=4, ckpt_dir=str(tmp_path))
    p = np.arange(2, 18, dtype=np.int32)
    eng.add_request(p)
    eng.decode_round()
    eng.pool_ckpt.drain()
    want = {n: eng.engine.pools[n].clone() for n in ("k", "v")}
    eng.engine.kill_pool("k")
    eng.engine.kill_pool("v")
    rep = eng.recover()
    assert rep.pools_restored == ("k", "v") and rep.replayed_flushes == 0
    for n in ("k", "v"):
        assert torch.equal(eng.engine.pools[n].view(torch.int16),
                           want[n].view(torch.int16))
    assert eng.pool_ckpt._cursor == 0
    assert eng.decode_round()
