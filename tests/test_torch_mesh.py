"""The port's sharded bulk movement over a rank mesh against the JAX
package, on the CPU (a mesh of 8 ranks, (2, 4) over ``("data",
"model")``, every rank on the CPU):

* the three-way property of ``test_property_mesh_fused_three_way_parity``
  (its five generated programs and the 600-row overflow case): the port's
  fan-out, single-slab fused drain, mesh drain and mesh fan-out leave
  pools bitwise equal to each other and to the JAX single-device engine,
  with one ``fused_mesh`` dispatch per flushed chunk (two for 600 rows);
* ``MESH_DISPATCH_SCRIPT``'s cases (``tests/test_multidevice.py``), the
  unshardable-pool warning, the adversarial delta subsets, crash replay
  under the mesh, ``check_plan`` on the reference's planted case and a
  sanitized mesh engine, replicated staging pools, and PSM migration over
  the mesh against the JAX engine's;
* K7's plain version against the reference's global PSM (``_psm_jit`` on
  ids ``rank * slab + local``) at every hop, and its host contract;
* ONE subprocess with 8 forced JAX host devices that holds the port's
  mesh drain against the reference's own sharded drain.
"""
import itertools
import os
import random
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _meshproc import run_device_subprocess
from test_dispatch_properties import gen_program, mk_engine, run_program
from test_torch_contract import (PortHook, assert_same_pools, bits,
                                 port_engine_like, run_program_port,
                                 to_torch)

import repro.core.migration as jmig
from repro.core import PagedCoWCache as JCache
from repro.core.rowclone import _psm_jit
from repro.core.cmdqueue import partition_commands as jpartition
from repro.core.sanitizer import DrainSanitizer as JSanitizer
from repro.core.sanitizer import SanitizerError as JSanitizerError
import repro_torch.core.migration as tmig
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.cmdqueue import partition_commands
from repro_torch.core.cow_cache import PagedCoWCache as TCache
from repro_torch.core.opcodes import OP_FPM_COPY, OP_NOP
from repro_torch.core.poolspec import BlockRef, PoolGroup, PoolSpec
from repro_torch.core.rowclone import MeshPools, RowCloneEngine
from repro_torch.core.sanitizer import DrainSanitizer, SanitizerError
from repro_torch.kernels import fused_dispatch as tfd
from repro_torch.kernels import ops
from repro_torch.kernels import psm_transfer as k7
from repro_torch.launch.mesh import make_test_mesh

MESH = make_test_mesh((2, 4), ("data", "model"), devices="cpu")


def mesh_engine_like(jeng, use_fused=True, mesh=MESH, group=None,
                     sanitize=None):
    """A port engine over ``mesh`` on the JAX engine's bytes and layout."""
    a = jeng.alloc
    alloc = SubarrayAllocator(a.num_blocks, a.num_slabs,
                              reserved_zero_per_slab=len(a.zero_rows)
                              // a.num_slabs)
    pools = {n: to_torch(p) for n, p in jeng.pools.items()}
    return RowCloneEngine(pools, alloc, mesh=mesh,
                          block_axis=jeng.block_axis,
                          staging=None if group else dict(jeng.staging),
                          group=group, use_fused=use_fused,
                          max_requests=jeng.max_requests, sanitize=sanitize)


def property_cases():
    """The reference's three-way cases (same seed, same draws)."""
    rng = random.Random(0xC10E)
    cases = []
    for _ in range(5):
        nblk = rng.choice([32, 64])
        snblk = rng.choice([nblk, nblk // 2, nblk // 4])
        ba = rng.randrange(2)
        cases.append({"nblk": nblk, "block_axis": ba, "stage_nblk": snblk,
                      "prog": gen_program(rng, nblk, rng.randint(2, 7),
                                          stage_nblk=snblk)})
    cases.append({"nblk": 2048, "block_axis": 0, "stage_nblk": None,
                  "prog": [["copy", [[i, 1024 + i] for i in range(600)]]]})
    return cases


CASES = property_cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_mesh_three_way_parity_with_reference(case):
    c = CASES[case]
    nblk, ba, snblk, prog = c["nblk"], c["block_axis"], c["stage_nblk"], \
        c["prog"]
    jeng = mk_engine(nblk, ba, use_fused=True, stage_nblk=snblk)
    fanout = port_engine_like(mk_engine(nblk, ba, use_fused=False,
                                        stage_nblk=snblk))
    single = port_engine_like(jeng)
    mesh = mesh_engine_like(jeng)
    mesh_fanout = mesh_engine_like(jeng, use_fused=False)
    ev_j = run_program(jeng, prog)
    ev = {n: run_program_port(e, prog) for n, e in (
        ("fanout", fanout), ("single", single), ("mesh", mesh),
        ("mesh_fanout", mesh_fanout))}
    for n, e in (("fanout", fanout), ("single", single), ("mesh", mesh),
                 ("mesh fan-out", mesh_fanout)):
        assert_same_pools(jeng, e, f"{n} case={case}")
    assert all(e[2] == "fused_mesh" for e in ev["mesh"]), ev["mesh"]
    assert len(ev["mesh"]) == len(ev["single"]) == len(ev_j) == \
        mesh.stats.launches
    assert mesh.queue.stats.hazard_flushes == \
        single.queue.stats.hazard_flushes
    assert mesh.queue.stats.war_hazards == single.queue.stats.war_hazards
    assert len(ev["mesh_fanout"]) == len(ev["fanout"])
    if case == len(CASES) - 1:
        assert len(ev["mesh"]) == 2          # 512 + 88 rows: two chunks


# ---------------------------------------------------------------------------
# MESH_DISPATCH_SCRIPT (tests/test_multidevice.py), on the port
# ---------------------------------------------------------------------------

def build(seed=0, use_fused=True, nblk=64):
    gen = np.random.default_rng(seed)
    pools = {n: torch.from_numpy(gen.standard_normal((nblk, 4, 8))
                                 .astype(np.float32)) for n in ("k", "v")}
    return RowCloneEngine(pools, SubarrayAllocator(nblk, 4), mesh=MESH,
                          use_fused=use_fused)


def snap(eng):
    return {n: p.clone() for n, p in eng.pools.items()}


@pytest.mark.parametrize("use_fused", [True, False])
def test_mixed_flush_is_one_mesh_launch(use_fused):
    eng = build(use_fused=use_fused)
    want = snap(eng)
    eng.alloc.mark_written([2, 5, 17, 33, 12])
    with PortHook() as events:
        with eng.batch():
            eng.memcopy([(2, 3), (5, 60), (17, 26)])
            eng.materialize_zeros([40])
            eng.memcopy_cross([(BlockRef("k", 12), BlockRef("v", 13)),
                               (BlockRef("k", 33), BlockRef("v", 58))])
    if use_fused:
        assert len(events) == 1 and events[0][2] == "fused_mesh"
    ref_ = {n: t.clone() for n, t in want.items()}
    for n in ("k", "v"):
        ref_[n][3] = want[n][2]
        ref_[n][60] = want[n][5]
        ref_[n][26] = want[n][17]
        ref_[n][40] = 0
    ref_["v"][13] = want["k"][12]
    ref_["v"][58] = want["k"][33]
    for n in ref_:
        assert torch.equal(eng.pools[n], ref_[n]), n


def test_hazard_flush_across_a_slab_boundary():
    eng = build(seed=7)
    a, b, c = 2, 33, 50                      # shards 0, 4, 6
    olda = eng.pools["k"][a].clone()
    eng.alloc.mark_written([a])
    with PortHook() as events:
        with eng.batch():
            eng.memcopy([(a, b)])
            eng.memcopy([(b, c)])
    assert eng.queue.stats.hazard_flushes == 1
    assert len(events) == 2
    assert torch.equal(eng.pools["k"][b], olda)
    assert torch.equal(eng.pools["k"][c], olda)


def test_empty_slab_flush_and_all_nop_table():
    eng = build(seed=11)
    want = snap(eng)
    eng.alloc.mark_written([1, 2])
    with PortHook() as events:
        with eng.batch():
            eng.memcopy([(1, 4), (2, 5)])
            eng.materialize_zeros([6])
    assert len(events) == 1
    for n in ("k", "v"):
        r = want[n].clone()
        r[4], r[5], r[6] = want[n][1], want[n][2], 0
        assert torch.equal(eng.pools[n], r)
    with PortHook() as events:
        n = eng.flush() + eng._dispatch_table(
            np.full((8, 3), OP_NOP, np.int32))
    assert n == 0 and not events


def test_unshardable_pool_warns_once_and_degrades():
    nblk = 36                                 # % 8 != 0
    gen = np.random.default_rng(0)
    pool = torch.from_numpy(gen.standard_normal((nblk, 4, 8))
                            .astype(np.float32))
    want = pool.clone()
    alloc = SubarrayAllocator(nblk, 4)
    eng = RowCloneEngine({"k": pool}, alloc, mesh=MESH)
    assert [len(s) for s in eng.slabs("k")] == [5] * 7 + [1]
    alloc.mark_written([1])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with PortHook() as events:
            eng.memcopy([(1, 2)])
            eng.memcopy([(3, 35)])            # onto the last, short slab
    hits = [x for x in w if "legacy" in str(x.message)]
    assert len(hits) == 1, [str(x.message) for x in w]
    assert {e[2] for e in events} == {"legacy_fpm", "legacy_psm"}
    assert torch.equal(eng.pools["k"][2], want[1])
    assert torch.equal(eng.pools["k"][35], want[3])


def test_adversarial_delta_subsets_one_launch_each():
    """24 flushes (3 x the reference's default signature bound) with
    pairwise-distinct delta subsets: each drains as ONE launch of its own
    plan, unfolded (the port compiles nothing per plan, so it bounds no
    cache: ROADMAP §3), pools bitwise equal to the JAX single-device
    engine."""
    jeng = mk_engine(64, 0, use_fused=True)
    eng = mesh_engine_like(jeng)
    for e in (jeng, eng):
        e.alloc.mark_written(list(range(1, 8)))
    subsets = []
    for r in (1, 2, 3):
        subsets.extend(itertools.combinations(range(1, 8), r))
    subsets = subsets[:24]
    for i, subset in enumerate(subsets):
        pairs = [(1 + j, delta * 8 + 7) for j, delta in enumerate(subset)]
        jeng.memcopy(pairs)
        eng.memcopy(pairs)
        assert eng.stats.launches == i + 1
        assert eng._last_plan_sig[1] == subset, (subset, eng._last_plan_sig)
    assert_same_pools(jeng, eng, "(delta subsets)")


@pytest.mark.parametrize("case", range(3))
def test_crash_replay_bitwise_under_the_mesh(case):
    rng = random.Random(0xFA117)
    for _ in range(case + 1):
        ba = rng.randrange(2)
        prog = gen_program(rng, 64, rng.randint(2, 6), stage_nblk=32)
        cut = rng.randint(0, len(prog))
    eng = mesh_engine_like(mk_engine(64, ba, use_fused=True, stage_nblk=32))
    run_program_port(eng, prog[:cut])
    snapshot = eng.snapshot()
    run_program_port(eng, prog[cut:])
    want = {n: p.clone() for n, p in eng.pools.items()}
    replayable = len(eng.journal.since(snapshot.index))
    for n in list(eng.pools):
        eng.kill_pool(n)
        assert eng.pool_is_dead(n)
    rep = eng.recover(snapshot=snapshot)
    assert set(rep.pools_restored) == set(eng.pools)
    assert rep.replayed_flushes == replayable
    for n in eng.pools:
        np.testing.assert_array_equal(bits(eng.pools[n]), bits(want[n]),
                                      err_msg=f"pool {n} ba={ba} cut={cut}")


def test_check_plan_matches_reference():
    """The reference's planted case (tests/test_rowlint_sanitizer.py):
    an exact partition passes, a row the plan never saw is a
    ``plan-partition`` finding, with the reference's message."""
    jeng = mk_engine(16, 0, True)
    teng = port_engine_like(jeng)
    rows = [(OP_FPM_COPY, 0, 1), (OP_FPM_COPY, 8, 9)]
    replicated = (False,) * len(teng.group)
    got = []
    for san, part, err in ((JSanitizer(jeng), jpartition, JSanitizerError),
                           (DrainSanitizer(teng), partition_commands,
                            SanitizerError)):
        plan = part(rows, n_shards=2, group=san.engine.group,
                    replicated=replicated)
        san.check_plan(rows, plan, replicated)
        assert san.plans_checked == 1
        with pytest.raises(err) as ei:
            san.check_plan(rows + [(OP_FPM_COPY, 4, 5)], plan, replicated)
        got.append([(f.check, f.message, f.row)
                    for f in ei.value.report.findings])
        assert san.reports[-1].checks == ("plan-partition",
                                          "plan-war-adjacency")
    assert got[0] == got[1] and got[1][0][0] == "plan-partition"


def test_sanitized_mesh_engine_checks_every_plan():
    rng = random.Random(3)
    prog = gen_program(rng, 32, 6, stage_nblk=16)
    jeng = mk_engine(32, 1, use_fused=True, stage_nblk=16)
    eng = mesh_engine_like(jeng, sanitize=True)
    run_program(jeng, prog)
    run_program_port(eng, prog)
    san = eng.sanitizer
    assert san.plans_checked == eng.stats.launches > 0
    assert san.shadow_runs == eng.stats.launches
    assert all(r.ok for r in san.reports)
    assert_same_pools(jeng, eng, "(sanitized mesh)")


@pytest.mark.parametrize("seed", range(3))
def test_replicated_staging_ring_on_the_mesh(seed):
    """Staging pools held whole on every rank (``sharding=()``):
    promotions read the local replica, a flush writing a replica from a
    sharded source degrades to the fan-out (K7 to every rank), and the
    pools stay bitwise equal to the JAX single-device engine's."""
    rng = random.Random(100 + seed)
    nblk, snblk = 64, 12                      # a ring not divisible by 8
    prog = gen_program(rng, nblk, 6, stage_nblk=snblk)
    jeng = mk_engine(nblk, seed % 2, use_fused=True, stage_nblk=snblk)
    shape = lambda n: tuple(jeng.pools["k"].shape[:jeng.block_axis]) + \
        (n,) + tuple(jeng.pools["k"].shape[jeng.block_axis + 1:])
    group = PoolGroup([
        PoolSpec("k", nblk, shape(nblk)), PoolSpec("v", nblk, shape(nblk)),
        PoolSpec("k_stage", snblk, shape(snblk), role="staging", paired="k",
                 sharding=()),
        PoolSpec("v_stage", snblk, shape(snblk), role="staging", paired="v",
                 sharding=())])
    eng = mesh_engine_like(jeng, group=group)
    assert [tuple(s.shape) for s in eng.slabs("k_stage")] == \
        [tuple(jeng.pools["k_stage"].shape)] * 8
    run_program(jeng, prog)
    with PortHook() as events:
        run_program_port(eng, prog)
    assert_same_pools(jeng, eng, f"(replicated ring, seed={seed})")
    for name in ("k_stage", "v_stage"):
        for s in eng.slabs(name):
            assert torch.equal(s, eng.slabs(name)[0])
    assert events


@pytest.mark.parametrize("case", range(2))
def test_ragged_mesh_degrades_to_the_fan_out_bitwise(case):
    """Pools the ranks do not divide (32 and 16 blocks over 3 ranks: slabs
    of 11, 11, 10 and 6, 6, 4) drain every flush through the mesh fan-out
    (copies by K5a / K5b or K7 across ranks, zeros per rank, bitwise rows
    on the gathered pools), bitwise equal to the JAX engine."""
    rng = random.Random(700 + case)
    prog = gen_program(rng, 32, 8, stage_nblk=16)
    jeng = mk_engine(32, case, use_fused=True, stage_nblk=16)
    eng = mesh_engine_like(jeng, mesh=make_test_mesh((3,), ("model",),
                                                     devices="cpu"))
    assert [s.shape[case] for s in eng.slabs("k")] == [11, 11, 10]
    run_program(jeng, prog)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        events = run_program_port(eng, prog)
    assert events and not any(e[2] == "fused_mesh" for e in events)
    assert_same_pools(jeng, eng, f"(ragged mesh, case={case})")


def test_mesh_pools_accessor():
    eng = build(seed=5)
    assert isinstance(eng.pools, MeshPools) and list(eng.pools) == ["k", "v"]
    whole = eng.pools["k"]
    assert tuple(whole.shape) == (64, 4, 8)
    assert torch.equal(whole, torch.cat(eng.slabs("k")))
    whole[0] = 7.0                            # a copy: the slabs keep theirs
    assert not torch.equal(eng.slabs("k")[0][0], whole[0])
    eng.pools["k"] = whole                    # assigning writes the slabs
    assert torch.equal(eng.slabs("k")[0][0], whole[0])
    assert eng.pool_bytes_resident() == 2 * 64 * 4 * 8 * 4
    eng.kill_pool("v")
    with pytest.raises(RuntimeError, match="killed"):
        eng.pools["v"]


# ---------------------------------------------------------------------------
# K7's plain version and contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("n", [4, 8])
def test_psm_transfer_plain_matches_reference_global_psm(n, block_axis):
    """Every hop -(n-1) .. n-1 and skip rows: K7's plain version on the
    ranks' slabs equals the reference's ``_psm_jit`` on the global pool
    with ids ``rank * slab + local``."""
    ss = 32                      # sources in blocks 0-15, dsts in 16-31
    gen = np.random.default_rng(n + block_axis)
    shape = (ss * n, 4, 16) if block_axis == 0 else (3, ss * n, 4, 16)
    pool = gen.standard_normal(shape).astype(np.float32)
    hops = list(range(-(n - 1), n))
    ids = np.full((n, len(hops), 3), -1, np.int64)
    free = {r: list(gen.permutation(np.arange(16, ss))) for r in range(n)}
    for my in range(n):
        for j, hop in enumerate(hops):
            if gen.random() < 0.15:
                continue                      # a skip row (src = -1)
            ids[my, j] = (gen.integers(0, 16), free[(my + hop + n) % n].pop(),
                          hop)
    live = ids[ids[:, :, 0] >= 0]
    assert set(live[:, 2].tolist()) == set(hops)
    assert (ids[:, :, 0] < 0).any()
    glob = []
    for my in range(n):
        for s, d, hop in ids[my][ids[my, :, 0] >= 0].tolist():
            glob.append((my * ss + s, ((my + hop + n) % n) * ss + d))
    g = np.asarray(glob, np.int32)
    if block_axis == 0:
        want = np.array(_psm_jit(jnp.asarray(pool), jnp.asarray(g)))
    else:
        want = pool.copy()
        want[:, g[:, 1]] = pool[:, g[:, 0]]
    whole = torch.from_numpy(pool.copy())
    slabs = [s.clone() for s in torch.split(whole, ss, dim=block_axis)]
    out = ops.psm_transfer(slabs, ids, block_axis=block_axis)
    got = torch.cat(out, dim=block_axis)
    np.testing.assert_array_equal(bits(got), bits(torch.from_numpy(want)))


def test_psm_transfer_refuses_off_contract_rows():
    slabs = [torch.zeros((4, 2, 3)) for _ in range(4)]
    t = [(slabs, slabs)]
    bad = {
        "hop": [0, 0, 1, 2, 4],                  # |hop| >= n
        "rank": [0, 5, 1, 2, 1],
        "block": [0, 0, 4, 2, 1],
        "table": [1, 0, 1, 2, 1],
    }
    for what, row in bad.items():
        with pytest.raises(ValueError, match="outside"):
            ops.psm_transfer_rows(t, [row])
    # two rows writing one block
    with pytest.raises(ValueError, match="writes a block another row"):
        ops.psm_transfer_rows(t, [[0, 0, 1, 2, 1], [0, 2, 3, 2, -1]])
    # a source another row of the call writes
    with pytest.raises(ValueError, match="reads a block row"):
        ops.psm_transfer_rows(t, [[0, 0, 1, 2, 1], [0, 1, 2, 3, 1]])
    # a row reading the block it writes is a no-op, allowed
    ops.psm_transfer_rows(t, [[0, 1, 2, 2, 0]])
    # a CUDA kernel asked for a CPU slab
    with pytest.raises(ValueError, match="CPU tensor"):
        ops.psm_transfer(slabs, np.zeros((4, 1, 3)), use_kernel=True)
    assert k7.rank_rows(np.array([[[-1, 0, 0]], [[2, 3, -1]]]), 2).tolist() \
        == [[0, 1, 2, 3, -1]]


# ---------------------------------------------------------------------------
# PSM migration over the mesh
# ---------------------------------------------------------------------------

def _mig_script(cache):
    sids = [cache.new_sequence(prompt_len=n, prefer_slab=0)
            for n in (8, 12, 4, 16)]
    sids.append(cache.new_sequence(prompt_len=6, prefer_slab=1))
    for sid in sids:
        cache.alloc.mark_written(cache.blocks_of(sid))
    cache.fork(sids[2], 1)
    return sids


@pytest.mark.parametrize("use_fused", [True, False])
def test_migration_over_the_mesh_matches_reference(use_fused):
    """``plan_rebalance`` on a mesh engine's cache gives the JAX plan, and
    issuing it moves the blocks across ranks (through K7's plain version
    here) to pools bitwise equal to the JAX single-device engine's."""
    jeng = mk_engine(64, 1, use_fused=True, stage_nblk=8, seed=7)
    teng = mesh_engine_like(mk_engine(64, 1, use_fused=use_fused,
                                      stage_nblk=8, seed=7),
                            use_fused=use_fused)
    jc, tc = JCache(jeng, 4, 8, 8), TCache(teng, 4, 8, 8)
    assert _mig_script(jc) == _mig_script(tc)
    jplan, tplan = jmig.plan_rebalance(jc), tmig.plan_rebalance(tc)
    assert tplan.moves and tplan.moves == jplan.moves
    assert tplan.pair_batches == jplan.pair_batches
    with PortHook() as events:
        assert tmig.execute(tplan, tc, chunk_blocks=2) == \
            jmig.execute(jplan, jc, chunk_blocks=2)
    ranks = {(s // 8, d // 8) for s, d in tplan.moves}
    assert any(a != b for a, b in ranks)      # blocks change rank
    assert teng.stats.psm_copies > 0
    assert {e[2] for e in events} == ({"fused_mesh"} if use_fused else
                                      {"legacy_psm"})
    assert_same_pools(jeng, teng, "(mesh migration)")


# ---------------------------------------------------------------------------
# against the reference's own sharded drain (one subprocess)
# ---------------------------------------------------------------------------

REFERENCE_MESH_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["REPRO_NO_TUNED"] = "1"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh

sys.path.insert(0, __TEST_DIR__)
from test_dispatch_properties import mk_engine, run_program
from test_torch_contract import bits, run_program_port
from test_torch_mesh import CASES, mesh_engine_like

mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
out = []
for i in (2,):
    c = CASES[i]
    jeng = mk_engine(c["nblk"], c["block_axis"], use_fused=True, mesh=mesh,
                     stage_nblk=c["stage_nblk"])
    teng = mesh_engine_like(mk_engine(c["nblk"], c["block_axis"],
                                      use_fused=True,
                                      stage_nblk=c["stage_nblk"]))
    ev_j = run_program(jeng, c["prog"])
    ev_t = run_program_port(teng, c["prog"])
    same = all(np.array_equal(bits(jeng.pools[n]), bits(teng.pools[n]))
               for n in jeng.pools)
    out.append({"case": i, "same": bool(same),
                "jax": [e[2] for e in ev_j], "port": [e[2] for e in ev_t],
                "jax_sig": list(map(str, [jeng._last_plan_sig])),
                "port_sig": list(map(str, [teng._last_plan_sig]))})
print("RESULTS:" + json.dumps(out))
"""


@pytest.mark.mesh
def test_port_mesh_drain_matches_reference_sharded_drain(tmp_path):
    child = REFERENCE_MESH_CHILD.replace(
        "__TEST_DIR__", repr(os.path.dirname(os.path.abspath(__file__))))
    res = run_device_subprocess(child, tmp_path=tmp_path, timeout=600)
    assert len(res) == 1
    for r in res:
        assert r["same"], r
        assert r["jax"] == r["port"] and set(r["port"]) == {"fused_mesh"}
        assert r["jax_sig"] == r["port_sig"], r


MIXED_SCRIPT = (("memcopy", [(1, 40), (9, 3), (17, 58), (63, 12)]),
                ("memnot", [(30, 20), (2, 45)]),
                ("memand", [(41, 50, 26), (1, 9, 33)]),
                ("memor", [(50, 63, 5)]),
                ("meminit", [41]))


def run_mixed(eng):
    eng.alloc.mark_written([1, 2, 9, 17, 30, 41, 50, 63])
    for verb, args in MIXED_SCRIPT:
        getattr(eng, verb)(args)


def assert_same_up_to_bf16_nan_payload(jpool, tpool, ctx):
    """Bitwise equality, except that where the JAX pool holds bf16's
    canonical NaN (0xffc0 / 0x7fc0) the port may hold another NaN: XLA on
    the CPU quiets a bf16 NaN that a bitwise op made (ROADMAP §3)."""
    want, got = bits(jpool), bits(tpool)
    if jpool.dtype == jnp.bfloat16:
        want, got = want.view(np.uint16), got.view(np.uint16)
        nan = (got & 0x7f80) == 0x7f80
        nan &= (got & 0x7f) != 0
        canon = (want == 0xffc0) | (want == 0x7fc0)
        got = np.where(nan & canon, want, got)
    np.testing.assert_array_equal(want, got, err_msg=ctx)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("v_shape", [(64, 4, 8), (64, 2, 16)])
def test_mixed_block_kinds_drain_bitwise(v_shape, use_fused):
    """A bf16 pool and an fp32 pool, both primary, of one block shape or
    two, move bit for bit over the mesh (each (block shape, dtype) lands
    through its own receive buffer, one K7 call each, on the sharded
    drain; per rank on the fan-out): pools bitwise equal to the port's
    single-device engine, and, at one block shape (the reference's fused
    drain takes one), to the JAX single-device engine."""
    import repro.core as jcore
    gen = np.random.default_rng(7)
    jpools = {"k": jnp.asarray(gen.standard_normal((64, 4, 8)),
                               jnp.bfloat16),
              "v": jnp.asarray(gen.standard_normal(v_shape), jnp.float32)}
    one = RowCloneEngine({n: to_torch(p) for n, p in jpools.items()},
                         SubarrayAllocator(64, 4))
    eng = RowCloneEngine({n: to_torch(p) for n, p in jpools.items()},
                         SubarrayAllocator(64, 4), mesh=MESH,
                         use_fused=use_fused)
    run_mixed(one)
    run_mixed(eng)
    for n in jpools:
        np.testing.assert_array_equal(bits(one.pools[n]), bits(eng.pools[n]),
                                      err_msg=f"pool {n}")
    if v_shape == (64, 4, 8):
        jeng = jcore.RowCloneEngine(jpools, jcore.SubarrayAllocator(64, 4))
        with warnings.catch_warnings():
            # the reference's scatter of fp32 rows into the bf16 pool
            warnings.simplefilter("ignore", FutureWarning)
            run_mixed(jeng)
        for n in jpools:
            assert_same_up_to_bf16_nan_payload(jeng.pools[n], eng.pools[n],
                                               f"pool {n}")


def test_k7_refuses_a_table_of_mixed_block_kinds():
    """A K7 table whose slabs differ in dtype or block shape is refused
    on the host: the plain version would otherwise cast a block."""
    n = 4
    src = [torch.zeros(8, 4, 8, dtype=torch.bfloat16) for _ in range(n)]
    for dst in ([torch.zeros(8, 4, 8) for _ in range(n)],
                [torch.zeros(8, 2, 16, dtype=torch.bfloat16)
                 for _ in range(n)]):
        with pytest.raises(ValueError, match="block shape and dtype"):
            ops.psm_transfer_rows([(src, dst)], [[0, 0, 1, 2, 1]])
