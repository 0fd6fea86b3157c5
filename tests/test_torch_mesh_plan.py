"""The port's mesh arithmetic and sharded partitioner against the JAX
package's, on the host:

* ``launch/mesh.py``: ``pool_shard_axes`` / ``pool_shard_count`` /
  ``pool_partition_spec`` on the same meshes and hints as
  ``repro/models/paged.py``;
* ``core/cmdqueue.py`` ``partition_commands`` / ``fold_shard_plan``: the
  flushed (hazard-free) tables of seeded random programs, partitioned by
  both packages over the same PoolGroup into 2, 4 and 8 shards, sharded
  and with replicated staging pools, give equal ``ShardPlan``s field for
  field, or the same ``ValueError``.
"""
import random
import types

import numpy as np
import pytest

from test_dispatch_properties import gen_program, mk_engine
from test_torch_contract import port_engine_like, run_program_port

import repro.core.cmdqueue as jq
import repro.core.poolspec as jps
import repro.models.paged as jpaged
import repro_torch.core.cmdqueue as tq
import repro_torch.core.poolspec as tps
from repro_torch.core.opcodes import (OP_AND, OP_CROSS_POOL_COPY,
                                      OP_FPM_COPY, OP_NOT, OP_OR,
                                      pack_bitwise_src)
from repro_torch.launch import mesh as tmesh

PLAN_FIELDS = ("n_shards", "shard_sizes", "n_local", "n_transfer",
               "n_spacers", "deltas")
PLAN_ARRAYS = ("local_tables", "send_rows", "recv_tables")


def assert_same_plan(jp, tp, ctx=""):
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f"{f} {ctx}"
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f"{f} {ctx}")


def flushed_tables(seed: int):
    """The live rows of every table a seeded random program flushes (the
    port engine's journal), with the engine's JAX twin."""
    rng = random.Random(seed)
    nblk = rng.choice([32, 64])
    snblk = rng.choice([nblk, nblk // 2, nblk // 4])
    jeng = mk_engine(nblk, seed % 2, use_fused=True, stage_nblk=snblk)
    teng = port_engine_like(jeng)
    run_program_port(teng, gen_program(rng, nblk, 8, stage_nblk=snblk))
    tables = [[r for r in rec.rows if r[0] >= 0]
              for rec in teng.journal.records]
    return jeng, teng, [t for t in tables if t]


def partition_both(rows, S, jgroup, tgroup, replicated):
    """``(jax plan or error, port plan or error)``."""
    out = []
    for mod, group in ((jq, jgroup), (tq, tgroup)):
        try:
            out.append(mod.partition_commands(rows, n_shards=S, group=group,
                                              replicated=replicated))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("replicate_staging", [False, True])
@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_shard_plans_match_reference(seed, S, replicate_staging):
    jeng, teng, tables = flushed_tables(seed)
    assert tables
    replicated = tuple(replicate_staging and spec.role == "staging"
                       for spec in teng.group)
    n_plans = 0
    for i, rows in enumerate(tables):
        jp, tp = partition_both(rows, S, jeng.group, teng.group, replicated)
        if isinstance(jp, str):
            assert tp == jp, (i, rows)
            continue
        n_plans += 1
        assert_same_plan(jp, tp, f"(seed={seed} S={S} table {i})")
        assert_same_plan(jq.fold_shard_plan(jp), tq.fold_shard_plan(tp),
                         f"folded (seed={seed} S={S} table {i})")
    assert n_plans


def _ring_groups(nblk=16, snblk=8):
    specs = lambda mod: [mod.PoolSpec("k", nblk), mod.PoolSpec("v", nblk),
                         mod.PoolSpec("k_stage", snblk, role="staging",
                                      paired="k")]
    return jps.PoolGroup(specs(jps)), tps.PoolGroup(specs(tps))


def test_two_source_rows_split_into_overwrite_and_combine():
    """AND / OR / NOT rows whose sources sit on other shards: srcA as a
    phase-0 overwrite (NOT inverting), srcB as a combine, a resident srcA
    as a local cross-pool copy, a resident srcB at hop distance 0."""
    jg, tg = _ring_groups()
    total = tg.total_blocks
    rows = [
        # AND: both sources on other shards than the dst (shard 3)
        (OP_AND, pack_bitwise_src(1, 5, total), 13),
        # OR: srcA resident on the dst shard (0), srcB on shard 2
        (OP_OR, pack_bitwise_src(16, 24 + 1, total), 17),
        # AND: srcA travels, srcB resident (hop distance 0)
        (OP_AND, pack_bitwise_src(9, 16 + 14, total), 16 + 15),
        # NOT from another shard
        (OP_NOT, pack_bitwise_src(2, 2, total), 16 + 9),
        (OP_CROSS_POOL_COPY, 32 + 3, 16 + 2),     # staging -> v
        (OP_FPM_COPY, 4, 12),
    ]
    for S in (2, 4):
        for rep in ((False,) * 3, (False, False, True)):
            jp, tp = partition_both(rows, S, jg, tg, rep)
            assert not isinstance(jp, str), jp
            assert_same_plan(jp, tp, f"S={S} replicated={rep}")
            combs = set(tp.recv_tables[..., 3].ravel().tolist())
            assert {OP_AND, OP_OR, OP_NOT, -1} <= combs
    jp, tp = partition_both(rows, 4, jg, tg, (False,) * 3)
    assert 0 in tp.deltas


def test_partition_value_errors_match_reference():
    jg, tg = _ring_groups(nblk=16, snblk=6)
    rows = [(OP_FPM_COPY, 0, 1)]
    # a replicated primary pool
    jp, tp = partition_both(rows, 2, jg, tg, (True, False, True))
    assert isinstance(tp, str) and tp == jp and "primary" in tp
    # a ragged pool (6 blocks over 4 shards)
    jp, tp = partition_both(rows, 4, jg, tg, None)
    assert isinstance(tp, str) and tp == jp and "divisible" in tp
    # a sharded source written into a replicated pool
    jg, tg = _ring_groups()
    jp, tp = partition_both([(OP_CROSS_POOL_COPY, 3, 32 + 1)], 2, jg, tg,
                            (False, False, True))
    assert isinstance(tp, str) and tp == jp and "broadcast" in tp


def test_fold_keeps_a_full_or_empty_plan():
    jg, tg = _ring_groups()
    local = [(OP_FPM_COPY, 0, 1)]
    for rows in (local, [(OP_FPM_COPY, 0, 9)]):
        jp, tp = partition_both(rows, 2, jg, tg, None)
        assert tq.fold_shard_plan(tp) is tp
        assert_same_plan(jq.fold_shard_plan(jp), tq.fold_shard_plan(tp))


def _duck(axes, shape):
    """A stand-in for a jax Mesh: the reference's arithmetic reads only
    ``axis_names`` and ``shape``."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


MESHES = [(("data", "model"), (2, 4)), (("model",), (8,)),
          (("pod", "data", "model"), (2, 2, 2)), (("data",), (1,))]


@pytest.mark.parametrize("axes,shape", MESHES)
def test_mesh_arithmetic_matches_reference(axes, shape):
    tm = tmesh.make_test_mesh(shape, axes, devices="cpu")
    jm = _duck(axes, shape)
    assert tmesh.pool_shard_axes(tm) == jpaged.pool_shard_axes(jm)
    assert tmesh.pool_shard_count(tm) == jpaged.pool_shard_count(jm)
    for hint in (None, (), ("model",), ("data", "model"), ("expert",)):
        for ba in (0, 1):
            want = tuple(jpaged.pool_partition_spec(jm, hint, block_axis=ba))
            got = tmesh.pool_partition_spec(tm, hint, block_axis=ba)
            # the reference names a single axis bare, several as a tuple
            norm = tuple(x if x is None or isinstance(x, tuple) else (x,)
                         for x in want)
            assert got == norm, (hint, ba)
    assert tmesh.pool_shard_count(None) == jpaged.pool_shard_count(None) == 1
    ranks = tmesh.pool_shard_ranks(tm)
    assert sorted(ranks) == list(range(tm.size))


def test_mesh_names_its_devices():
    with pytest.raises(TypeError):
        tmesh.make_test_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        tmesh.DeviceMesh(("data",), (4,), ("cpu",) * 2)
    m = tmesh.make_test_mesh((2,), ("data",), devices=["cpu", "cpu"])
    assert m.size == 2 and m.devices[1].type == "cpu"
    # the shard order of the pool axes, whatever order the mesh lists them
    m = tmesh.make_test_mesh((2, 3), ("model", "data"), devices="cpu")
    assert tmesh.pool_shard_ranks(m) == (0, 3, 1, 4, 2, 5)
    with pytest.raises(ValueError):
        tmesh.pool_shard_ranks(tmesh.make_test_mesh((2, 2),
                                                    ("expert", "model"),
                                                    devices="cpu"))
