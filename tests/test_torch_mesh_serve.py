"""The port's sharded serving over a rank mesh against the JAX package, on
the CPU: ``ServingEngine(mesh=)``, ``PagedCoWCache(batch_groups=)``, the
mesh arithmetic of ``models/paged.py``, the mesh branch of
``paged_attend_append`` and ``lse_combine``.

Three meshes, every rank on the CPU: (2, 4) over ``("data", "model")``
(the batch in 2 groups, partials combined over ``model``), (4,) over
``("model",)`` (a replicated batch, combined over every rank) and (4,)
over ``("data",)`` (4 groups of one rank, nothing to combine).

* the pure functions and the pool hints equal the reference's;
* the cache with ``batch_groups=2`` over a mesh engine against the JAX
  cache over one op script (admits, a same-group fork, a cross-group
  fork, appends, frees): slots, groups, blocks, tables and pools equal;
* the facts of the reference's ``MESH_SERVE_CHILD``
  (``tests/test_serving_staging.py``) on the reduced llama3.2-3b: greedy
  tokens equal the JAX single-device engine's and the port's, group-pinned
  placement, an 8-slot ring against a full twin, a double-buffered burst
  and a replicated 3-slot ring at one ``fused_mesh`` dispatch a round, and
  dedup within groups; ``tests/test_multidevice.py``'s serving steps 5-6;
* moe, hybrid and encdec over the mesh against the port's single-device
  engine, demotion and the checkpoint stream with a recovery;
* the prefill's staging write and the decode append read back from
  ``engine.slabs``;
* ONE subprocess with 8 forced JAX host devices holds ``paged_attend_append``
  against the reference's ``shard_map``'d one, fp32, ``OUT_ATOL``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _meshproc import run_device_subprocess
from test_dispatch_properties import mk_engine
from test_torch_contract import PortHook, bits
from test_torch_mesh import mesh_engine_like

import repro.models.paged as jpaged
from repro.configs import get_config as jget_config
from repro.core import PagedCoWCache as JCache
from repro.launch.serve import ServingEngine as JServing
from repro.models import build_model, split_params
from repro.models.attention import lse_combine as jlse_combine
from repro_torch.configs import get_config
from repro_torch.core.cow_cache import PagedCoWCache as TCache
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import paged
from repro_torch.models.attention import lse_combine
from repro_torch.runtime.fault import FaultPlan
from repro_torch.weights import from_jax_params, init_params

#: fp32 partials combined in another order than one slab's sweep
OUT_ATOL = 1e-5

MESHES = {"data x model": ((2, 4), ("data", "model")),
          "model": ((4,), ("model",)),
          "data": ((4,), ("data",))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's torch work on one CPU thread (as ``one_thread`` of
    test_torch_contract.py): under ``-n 6`` each worker's default pool
    oversubscribes the cores, and the reduced models gain nothing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(name):
    shape, axes = MESHES[name]
    return make_test_mesh(shape, axes, devices="cpu")


def jax_mesh_like(shape, axes):
    """The attributes of a JAX ``Mesh`` that the reference's arithmetic
    reads (``axis_names``, ``shape``), without forcing 8 host devices."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((4,), ("model",)), ((4,), ("data",)),
    ((2, 2, 2), ("pod", "data", "model")), ((8,), ("model",)),
    ((2, 1), ("data", "model"))])
def test_mesh_arithmetic_matches_reference(shape, axes):
    tm = make_test_mesh(shape, axes, devices="cpu")
    jm = jax_mesh_like(shape, axes)
    for batch in (1, 2, 3, 4, 6, 8, 16):
        b_axes = jpaged.batch_shard_axes(jm, batch)
        assert paged.batch_shard_axes(tm, batch) == b_axes
        assert paged.batch_shard_count(tm, batch) == \
            jpaged.batch_shard_count(jm, batch)
        assert paged.combine_axes(tm, b_axes) == \
            jpaged.combine_axes(jm, b_axes)
    assert paged.batch_shard_count(None, 8) == 1


@pytest.mark.parametrize("batch,seq_len,page,dp", [
    (8, 64, 16, 1), (8, 64, 16, 2), (8, 50, 16, 4), (6, 33, 8, 4),
    (4, 128, 64, 2)])
def test_identity_layout_matches_reference(batch, seq_len, page, dp):
    for a, b in zip(paged.identity_layout(batch, seq_len, page, dp),
                    jpaged.identity_layout(batch, seq_len, page, dp)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("rs,rc", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_serving_pool_hints_match_reference(rs, rc):
    _, jg = jpaged.make_serving_pools(2, 16, 4, 2, 8, jnp.float32,
                                      stage_nblk=3, replicate_staging=rs,
                                      ckpt_nblk=5, replicate_ckpt=rc)
    _, tg = paged.make_serving_pools(2, 16, 4, 2, 8, torch.float32, "cpu",
                                     stage_nblk=3, replicate_staging=rs,
                                     ckpt_nblk=5, replicate_ckpt=rc)
    assert [(s.name, s.nblk, s.role, s.paired, s.sharding) for s in tg] == \
        [(s.name, s.nblk, s.role, s.paired, s.sharding) for s in jg]


def test_lse_combine_matches_reference_and_empty_ranks():
    """Four ranks' partials through the reference's ``pmax`` / ``psum``
    (``vmap`` over a named axis) and through the port; a rank with no
    visible page of a row holds K2's ``m = -1e30, l = 0, acc = 0`` (the
    plain version, as the kernel) and adds nothing, with no NaN; a row no
    rank sees comes out 0."""
    rng = np.random.default_rng(0)
    R, B, H, D, page = 4, 3, 4, 8, 4
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    slabs = rng.standard_normal((R, 2, page, 2, D)).astype(np.float32)
    vslabs = rng.standard_normal((R, 2, page, 2, D)).astype(np.float32)
    mask = np.zeros((R, 2, B), np.int8)
    mask[0, :, 0] = 1          # row 0 only on rank 0
    mask[1, 0, 1] = 1          # row 1 on ranks 1 and 3
    mask[3, 1, 1] = 1
    base = np.zeros((R, 2), np.int32)                      # row 2: nowhere
    lens = np.full(B, page, np.int32)
    parts = [kref.paged_attention_slab(
        torch.from_numpy(q), torch.from_numpy(slabs[r]),
        torch.from_numpy(vslabs[r]), torch.from_numpy(mask[r]),
        torch.from_numpy(base[r]), torch.from_numpy(lens), page=page)
        for r in range(R)]
    acc, l, m = (torch.stack(x) for x in zip(*parts))
    assert bool((m[2] == -1e30).all()) and float(l[2].abs().max()) == 0
    assert float(acc[2].abs().max()) == 0
    got = lse_combine(*zip(*parts))
    want = jax.vmap(lambda a, b, c: jlse_combine(a, b, c, "r"),
                    axis_name="r")(jnp.asarray(acc.numpy()),
                                   jnp.asarray(l.numpy()),
                                   jnp.asarray(m.numpy()))[0]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[2].abs().max()) == 0
    # row 0 lives on rank 0 alone: the combine is its own normalisation
    np.testing.assert_allclose(
        got[0].numpy(), (acc[0, 0] / l[0, 0][..., None]).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the cache with batch groups
# ---------------------------------------------------------------------------

PAGE, MAX_BLOCKS, MAX_SEQS = 4, 8, 4


def _cache_pair():
    jeng = mk_engine(64, 1, use_fused=True, stage_nblk=8, seed=5)
    teng = mesh_engine_like(mk_engine(64, 1, use_fused=True, stage_nblk=8,
                                      seed=5))
    return (JCache(jeng, PAGE, MAX_BLOCKS, MAX_SEQS, batch_groups=2),
            TCache(teng, PAGE, MAX_BLOCKS, MAX_SEQS, batch_groups=2))


def _same_cache(jc, tc):
    jt = [np.asarray(a) for a in jc.device_tables()]
    tt = [a.numpy() for a in tc.device_tables()]
    for name, a, b in zip(("block_table", "share_mask", "base"), jt, tt):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tt[1].shape == (64, MAX_SEQS // 2)
    np.testing.assert_array_equal(jc.seq_lens(), tc.seq_lens())
    assert sorted(jc.seqs) == sorted(tc.seqs)
    for sid in jc.seqs:
        assert jc.blocks_of(sid) == tc.blocks_of(sid)
        assert jc.slot_of(sid) == tc.slot_of(sid)
        assert jc.seqs[sid].group == tc.seqs[sid].group
        assert jc.seqs[sid].slab_home == tc.seqs[sid].slab_home
        assert all(tc.group_of_block(b) == tc.seqs[sid].group
                   for b in tc.blocks_of(sid))
    np.testing.assert_array_equal(jc.alloc.refcount, tc.alloc.refcount)
    np.testing.assert_array_equal(jc.alloc.is_zero, tc.alloc.is_zero)
    assert jc._free_slots == tc._free_slots


def test_group_cache_script_matches_reference():
    """Admits spread over both groups, a same-group fork (a CoW share),
    appends that split the shared block, a cross-group fork (group 0's
    slots full: an eager copy into group 1's slabs, which the mesh engine
    moves across ranks), frees, then the group checks of ``remap_blocks``
    and the divisibility check; the mesh engine's pools against the JAX
    engine's, bitwise."""
    jc, tc = _cache_pair()
    for jeng_c in (jc, tc):
        jeng_c.engine.alloc.mark_written(range(64))

    def both(fn):
        a, b = fn(jc), fn(tc)
        assert a == b
        _same_cache(jc, tc)
        return a

    a = both(lambda c: c.new_sequence(prompt_len=6))
    b = both(lambda c: c.new_sequence(prompt_len=9))
    assert jc.seqs[a].group != jc.seqs[b].group
    both(lambda c: c.append_tokens([a, b]))
    kid = both(lambda c: c.fork(a, 1))[0]
    assert jc.seqs[kid].group == jc.seqs[a].group
    assert jc.blocks_of(kid) == jc.blocks_of(a)
    both(lambda c: c.append_tokens([a, kid]))          # CoW split
    # the parent's group is full: the next child lands in b's group, its
    # blocks copied across
    assert not jc._free_slots[jc.seqs[a].group]
    cross = both(lambda c: c.fork(a, 1))[0]
    assert jc.seqs[cross].group == jc.seqs[b].group
    assert set(jc.blocks_of(cross)).isdisjoint(jc.blocks_of(a))
    for _ in range(5):
        both(lambda c: c.append_tokens(sorted(c.seqs)))
    both(lambda c: c.free_sequence(kid))
    both(lambda c: c.new_sequence(prompt_len=5))
    np.testing.assert_array_equal(bits(jc.engine.pools["k"]),
                                  bits(tc.engine.pools["k"]))
    np.testing.assert_array_equal(bits(jc.engine.pools["v"]),
                                  bits(tc.engine.pools["v"]))
    # remap_blocks refuses a block of the other group in both
    other = [b_ for b_ in range(64) if tc.group_of_block(b_)
             != tc.seqs[b].group][:len(tc.blocks_of(b))]
    msgs = []
    for c in (jc, tc):
        with pytest.raises(ValueError) as e:
            c.remap_blocks(b, other)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="must divide"):
        TCache(tc.engine, PAGE, MAX_BLOCKS, 3, batch_groups=2)


def test_cross_group_fork_rolls_back_on_exhaustion():
    """Group 0 full of slots and group 1 out of blocks: the cross-group
    eager fork raises ``OutOfBlocks`` and frees its partial clone, as the
    reference's."""
    from repro.core.allocator import OutOfBlocks as JOut
    from repro_torch.core.allocator import OutOfBlocks as TOut
    jc, tc = _cache_pair()
    for c in (jc, tc):
        c.engine.alloc.mark_written(range(64))
        a = c.new_sequence(prompt_len=6)
        b = c.new_sequence(prompt_len=4)
        c.fork(a, 1)                          # fills a's group
        slabs = c.group_slabs(c.seqs[b].group)
        left = sum(c.alloc.free_in_slab(s) for s in slabs)
        c.alloc.alloc(left - 1, allowed_slabs=slabs)
        free_before = c.alloc.total_free()
        with pytest.raises((JOut, TOut)):
            c.fork(a, 1)                      # 2 blocks into 1 free one
        assert c.alloc.total_free() == free_before == 1 + sum(
            c.alloc.free_in_slab(s) for s in c.group_slabs(c.seqs[a].group))
    _same_cache(jc, tc)


# ---------------------------------------------------------------------------
# the serving engine over the mesh: MESH_SERVE_CHILD's facts
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


def _margins(eng, sids):
    return {s: float(np.diff(np.sort(eng.last_logits[s])[-2:])[0])
            for s in sids}


def _main_script(eng, sink=None):
    """MESH_SERVE_CHILD's script: 3 prompts of 16 tokens, one round, fork
    the first, 3 rounds.  ``sink`` collects the fused dispatches of each
    round.  Returns the admitted sids."""
    rng = np.random.default_rng(3)
    sids = [eng.add_request(rng.integers(2, 512, size=16).astype(np.int32))
            for _ in range(3)]
    with PortHook() as ev:
        eng.decode_round()
        eng.fork(sids[0], 1)
        for _ in range(3):
            n0 = len(ev)
            eng.decode_round()
            assert len(ev) - n0 <= 1, ev
    if sink is not None:
        sink.extend(ev)
    return sids


@pytest.fixture(scope="module")
def main_tokens(served):
    """The JAX and the port single-device engines on the main script."""
    jcfg, params, cfg, tmodel = served
    jeng = JServing(jcfg, params, max_seqs=8)
    teng = ServingEngine(cfg, tmodel, max_seqs=8, device="cpu")
    sids = _main_script(jeng), _main_script(teng)
    assert sids[0] == sids[1]
    return ({s: jeng.tokens[s] for s in jeng.tokens},
            {s: teng.tokens[s] for s in teng.tokens},
            _margins(jeng, sids[0]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_engine_decodes_like_single_device(served, main_tokens,
                                                mesh_name):
    """Greedy tokens equal the JAX single-device engine's and the port's;
    the batch groups and mask columns follow the mesh; every block lies in
    its sequence's group; every round drains as at most one
    ``fused_mesh`` dispatch."""
    _, _, cfg, tmodel = served
    jtok, ttok, margins = main_tokens
    srv = ServingEngine(cfg, tmodel, mesh=mesh_of(mesh_name), max_seqs=8,
                        max_blocks_per_seq=8, num_slabs=4)
    groups = {"data x model": 2, "model": 1, "data": 4}[mesh_name]
    assert srv.cache.batch_groups == groups
    assert srv.cache.device_tables()[1].shape[1] == 8 // groups
    assert srv.engine.num_blocks % srv.engine.n_shards == 0
    assert srv.device == torch.device("cpu") and srv.engine.mesh is not None
    events = []
    _main_script(srv, events)
    assert {m for _, _, m in events} == {"fused_mesh"}
    assert srv.tokens == jtok == ttok, margins
    assert all(srv.cache.group_of_block(b) == seq.group
               for seq in srv.cache.seqs.values() for b in seq.blocks)
    if groups > 1:
        assert len({seq.group for seq in srv.cache.seqs.values()}) > 1


def test_ring_against_full_twin_on_the_mesh(served):
    """An 8-slot ring against a full-twin engine, both over the (2, 4)
    mesh: equal tokens, at most one ``fused_mesh`` dispatch a round, and
    >= 1.8x fewer resident pool bytes (the reference's ring leg)."""
    _, _, cfg, tmodel = served
    mesh = mesh_of("data x model")
    twin = ServingEngine(cfg, tmodel, mesh=mesh, max_seqs=8,
                         max_blocks_per_seq=16, num_slabs=4,
                         max_admit_pages=ServingEngine.FULL_TWIN)
    ring = ServingEngine(cfg, tmodel, mesh=mesh, max_seqs=8,
                         max_blocks_per_seq=16, num_slabs=4,
                         max_admit_pages=8)
    rng = np.random.default_rng(7)
    with PortHook() as ev:
        for _ in range(3):
            p = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
            tw, rg = twin.add_request(p.copy()), ring.add_request(p.copy())
            twin.decode_round()
            n0 = len(ev)
            ring.decode_round()
            assert len(ev) - n0 <= 1
        twin.fork(tw, 1)
        ring.fork(rg, 1)
        for _ in range(3):
            twin.decode_round()
            ring.decode_round()
    assert ring.engine.stage_capacity == 8 < ring.engine.num_blocks
    assert twin.tokens == ring.tokens
    assert {m for _, _, m in ev} == {"fused_mesh"}
    assert twin.pool_bytes_resident() / ring.pool_bytes_resident() >= 1.8


@pytest.mark.parametrize("leg", ["burst", "replicated"])
def test_burst_and_replicated_ring_on_the_mesh(served, leg):
    """A 2-slot double-buffered ring fed 3 staged pages a round, and a
    3-slot ring (the shard count does not divide it: replicated on every
    rank, hint ``()``): one ``fused_mesh`` dispatch a round, tokens equal
    the JAX single-device engine's with the same ring."""
    jcfg, params, cfg, tmodel = served
    kw = dict(max_admit_pages=2, double_buffer=True) if leg == "burst" \
        else dict(max_admit_pages=3)
    jeng = JServing(jcfg, params, max_seqs=8, max_blocks_per_seq=16, **kw)
    srv = ServingEngine(cfg, tmodel, mesh=mesh_of("data x model"),
                        max_seqs=8, max_blocks_per_seq=16, num_slabs=4, **kw)
    if leg == "replicated":
        assert srv.engine.stage_capacity == 3
        assert srv.engine.group["k_stage"].sharding == ()
        assert len(srv.engine.slabs("k_stage")) == 8
    rng = np.random.default_rng(11 if leg == "burst" else 13)
    rounds = []
    for _ in range(2 if leg == "burst" else 3):
        n = 3 if leg == "burst" else 1
        prompts = [rng.integers(2, cfg.vocab_size, size=24).astype(np.int32)
                   for _ in range(n)]
        for p in prompts:
            jeng.add_request(p.copy())
        jeng.decode_round()
        with PortHook() as ev:
            for p in prompts:
                srv.add_request(p.copy())
            srv.decode_round()
        rounds.append([m for _, _, m in ev])
    assert all(r == ["fused_mesh"] for r in rounds), rounds
    assert srv.tokens == jeng.tokens


def test_dedup_within_groups_on_the_mesh(served):
    """Identical prompts across tenants share blocks within a batch group
    only: tokens equal the dedup-off twin's, hits >= 1, fewer live KV
    bytes, every block in its sequence's group, and the rounds after the
    first at one ``fused_mesh`` dispatch."""
    _, _, cfg, tmodel = served
    mesh = mesh_of("data x model")
    off = ServingEngine(cfg, tmodel, mesh=mesh, max_seqs=8,
                        max_blocks_per_seq=8, num_slabs=4)
    on = ServingEngine(cfg, tmodel, mesh=mesh, max_seqs=8,
                       max_blocks_per_seq=8, num_slabs=4, dedup_admit=True)
    rng = np.random.default_rng(17)
    page = on.cache.page
    canon = [rng.integers(2, cfg.vocab_size,
                          size=2 * page + page // 2).astype(np.int32)
             for _ in range(2)]
    pairs = [(off.add_request(canon[t % 2].copy()),
              on.add_request(canon[t % 2].copy())) for t in range(4)]
    for rnd in range(3):
        off.decode_round()
        with PortHook() as ev:
            on.decode_round()
        assert on.last_ticket.launches <= 1
        assert len(ev) <= (3 if rnd == 0 else 1), ev
        assert {m for _, _, m in ev} <= {"fused_mesh"}
    assert all(off.tokens[a] == on.tokens[b] for a, b in pairs)
    assert on.dedup_hits >= 1
    assert on.kv_bytes_live() < off.kv_bytes_live()
    for seq in on.cache.seqs.values():
        assert all(on.cache.group_of_block(b) == seq.group
                   for b in seq.blocks)
    # a donor is shared only inside its group: each group registers its own
    keys = {on.cache.group_of_block(blk) for blk, _ in
            on._dedup_registry.values()}
    assert keys == {0, 1}


def test_serving_steps_of_the_multidevice_script(served):
    """``tests/test_multidevice.py`` steps 5-6 on the port: an eager fork
    captured on the serve stream launches nothing until the flush, which
    is one ``fused_mesh`` dispatch (the ticket agrees); staged promotions
    and a fork of the older sequence fuse into one dispatch and the
    staging slots are reclaimed."""
    _, _, cfg, tmodel = served
    srv = ServingEngine(cfg, tmodel, mesh=mesh_of("data x model"),
                        max_seqs=8, max_blocks_per_seq=8, num_slabs=4)
    assert srv.engine.num_blocks % 8 == 0 and srv.cache.batch_groups == 2
    sid = srv.cache.new_sequence(prompt_len=2 * srv.rc.page_size)
    srv.engine.alloc.mark_written(srv.cache.blocks_of(sid))
    with PortHook() as ev:
        with srv.stream.capture():
            srv.cache.fork(sid, 1, eager_copy=True)
        assert ev == []
        ticket = srv.stream.flush()
        assert [m for _, _, m in ev] == ["fused_mesh"]
        assert ticket.launches == 1
    with PortHook() as ev:
        stage_ids = srv.engine.stage_blocks(2)
        sid2 = srv.cache.new_sequence(prompt_len=2 * srv.rc.page_size)
        with srv.stream.capture():
            srv.engine.promote_staged(list(zip(stage_ids,
                                               srv.cache.blocks_of(sid2))))
            srv.cache.fork(sid, 1, eager_copy=True)
        assert ev == []
        srv.stream.flush()
        assert [m for _, _, m in ev] == ["fused_mesh"]
    assert all(s in srv.engine._stage_free for s in stage_ids)


def test_writes_reach_the_slabs(served):
    """No write under a mesh goes through ``engine.pools``: a staging
    write into the replicated 3-slot ring lands on every rank's replica
    (read back from ``engine.slabs``), and a decode round's appends land
    in the slab that holds each block (read back from ``engine.slabs``
    and equal to the single-device engine's appends)."""
    _, _, cfg, tmodel = served
    srv = ServingEngine(cfg, tmodel, mesh=mesh_of("data x model"),
                        max_seqs=8, max_blocks_per_seq=8, num_slabs=4,
                        max_admit_pages=3)
    one = ServingEngine(cfg, tmodel, max_seqs=8, max_blocks_per_seq=8,
                        num_slabs=4, max_admit_pages=3, device="cpu")
    L, page = cfg.num_attn_layers, srv.rc.page_size
    pages = torch.randn(L, 2, page, cfg.num_kv_heads, cfg.head_dim)
    srv.engine.write_blocks("k_stage", [2, 0], pages)
    for slab in srv.engine.slabs("k_stage"):
        assert torch.equal(slab[:, 2], pages[:, 0])
        assert torch.equal(slab[:, 0], pages[:, 1])
    # the K/V pools: a page written at global block b lands in its slab
    b = srv.engine.num_blocks - 3
    srv.engine.write_blocks("v", [b], pages[:, :1])
    assert torch.equal(srv.engine.block("v", b), pages[:, 0])
    srv.engine.write_blocks("v", [b], torch.zeros_like(pages[:, :1]))
    # decode appends at positions 16 and 17
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(2)]
    sids = [(one.add_request(p.copy()), srv.add_request(p.copy()))
            for p in prompts]
    for _ in range(2):
        one.decode_round()
        srv.decode_round()
    assert srv.tokens == one.tokens
    ss = srv.engine.num_blocks // 8
    for a, s in sids:
        for j, (ba, bs) in enumerate(zip(one.cache.blocks_of(a),
                                         srv.cache.blocks_of(s))):
            for name in ("k", "v"):
                got = srv.engine.slabs(name)[bs // ss][:, bs % ss]
                np.testing.assert_allclose(
                    got.numpy(), one.engine.pools[name][:, ba].numpy(),
                    atol=OUT_ATOL, err_msg=f"{name} block {j} of {s}")
        assert srv.cache.seqs[s].length == 18


def test_mesh_argument_validation(served):
    """A non-mesh raises, a device other than the mesh's raises, and the
    engine's device is the mesh's first shard's."""
    _, _, cfg, tmodel = served
    assert "mesh" not in tserve.NOT_PORTED
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(cfg, tmodel, mesh=object(), max_seqs=2,
                      max_blocks_per_seq=2)
    with pytest.raises(ValueError, match="first shard"):
        ServingEngine(cfg, tmodel, mesh=mesh_of("model"), max_seqs=2,
                      max_blocks_per_seq=2, device="meta")
    eng = ServingEngine(cfg, tmodel, mesh=mesh_of("model"), max_seqs=2,
                        max_blocks_per_seq=2, device="cpu")
    assert eng.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the other families, demotion and recovery over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_families_over_the_mesh_match_single_device(arch):
    """moe is served over the (2, 4) mesh (its FFN takes the local path:
    a batch of one does not divide over ``data``, and a decode step's one
    position not over ``model``); hybrid and encdec are admitted.  Each sequence's
    pages (gathered from the slabs at its blocks), its extras and, for
    moe, its greedy tokens equal the port's single-device engine's."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    one = ServingEngine(cfg, model, max_seqs=8, max_blocks_per_seq=8,
                        num_slabs=4, device="cpu")
    srv = ServingEngine(cfg, model, mesh=mesh_of("data x model"),
                        max_seqs=8, max_blocks_per_seq=8, num_slabs=4)
    rng = np.random.default_rng(1)
    sids = []
    for n in (20, 9):
        p = rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
        sids.append((one.add_request(p.copy()), srv.add_request(p.copy())))
    if cfg.family == "moe":
        for _ in range(3):
            one.decode_round()
            srv.decode_round()
        assert srv.tokens == one.tokens
    else:
        for eng in (one, srv):
            eng.stream.flush()
            eng._post_flush()
        with pytest.raises(NotImplementedError):
            srv.decode_round()
    for a, s in sids:
        for name in ("k", "v"):
            for ba, bs in zip(one.cache.blocks_of(a), srv.cache.blocks_of(s)):
                assert torch.equal(one.engine.block(name, ba),
                                   srv.engine.block(name, bs))
        assert one._extras.keys() == srv._extras.keys()
        for k in one._extras.get(a, {}):
            assert torch.equal(one._extras[a][k], srv._extras[s][k])


def test_demotion_and_checkpoint_recovery_over_the_mesh(served, tmp_path):
    """Demote / resume through 64 spill slots beside a 5-slot checkpoint
    window (69 slots: replicated on every rank, 69 % 8 != 0), a launch
    failure on the third round recovered in place: tokens equal the
    single-device engine's under the same script, and a killed staging
    ring under the mesh is seen by ``pool_is_dead`` instead of a gather
    that raises."""
    _, _, cfg, tmodel = served
    prompts = [np.random.default_rng(i).integers(
        2, cfg.vocab_size, size=12).astype(np.int32) for i in range(3)]

    def drive(mesh, sub, spill, ckpt):
        kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
        plan = FaultPlan()
        eng = ServingEngine(cfg, tmodel, max_seqs=8, max_blocks_per_seq=8,
                            num_slabs=4, spill_pages=spill, ckpt_pages=ckpt,
                            ckpt_dir=str(tmp_path / sub), fault_plan=plan,
                            auto_recover=True, **kw)
        order = [eng.add_request(p.copy()) for p in prompts]
        for r in range(6):
            if r == 1:
                eng.demote(order[1])
            if r == 2:
                plan.launch_failures += (eng.engine.next_flush_index,)
            if r == 3:
                order[1] = eng.resume(order[1])
            eng.decode_round()
        return eng, [eng.tokens[s] for s in order], plan

    one, want, _ = drive(None, "one", 64, 5)
    srv, got, plan = drive(mesh_of("data x model"), "mesh", 64, 5)
    assert [k for k, _ in plan.fired] == ["launch_failure"]
    assert srv.last_recovery is not None
    assert srv.engine.group["k_spill"].sharding == ()        # 69 % 8
    assert got == want
    srv.engine.kill_pool("k_stage")
    assert srv.engine.pool_is_dead("k_stage")
    with pytest.raises(RuntimeError, match="no storage"):
        srv.engine.pools["k_stage"]
    srv.recover()
    assert not srv.engine.pool_is_dead("k_stage")


# ---------------------------------------------------------------------------
# paged_attend_append against the reference's shard_map, 8 JAX devices
# ---------------------------------------------------------------------------

ATTEND_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import functools
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

from repro.models.paged import paged_attend_append as jpaa
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.paged import paged_attend_append, rank_appends

B, H, KVH, D, page, nblk = 8, 4, 2, 32, 4, 64
rng = np.random.default_rng(0)
out = {}
for name, shape, axes, dp in (("data x model, local", (2, 4),
                               ("data", "model"), 2),
                              ("data x model, global", (2, 4),
                               ("data", "model"), 1),
                              ("model", (4,), ("model",), 1),
                              ("data", (4,), ("data",), 4)):
    jm = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
              axes)
    tm = make_test_mesh(shape, axes, devices="cpu")
    bl = B // dp
    gsize = nblk // dp
    kp = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    mask = np.zeros((nblk, bl), np.int8)
    base = np.zeros(nblk, np.int32)
    lens = np.zeros(B, np.int32)
    ids = np.full(B, -1, np.int32)
    offs = np.zeros(B, np.int32)
    free = {g: list(rng.permutation(np.arange(g * gsize, (g + 1) * gsize)))
            for g in range(dp)}
    for b in range(B - 1):                 # the last slot stays empty
        g = b // bl
        n = int(rng.integers(1, 5))
        blocks = [int(free[g].pop()) for _ in range(n)]
        for j, blk in enumerate(blocks):
            mask[blk, b % bl] = 1
            base[blk] = j * page
        ln = (n - 1) * page + int(rng.integers(1, page + 1))
        lens[b] = ln
        ids[b], offs[b] = blocks[(ln - 1) // page], (ln - 1) % page
    # a CoW share: slot 1's first block also read by slot 0 (same group)
    if dp < 4:
        shared = int(np.nonzero(mask[:, 1 % bl])[0][0])
        mask[shared, 0] = 1
    jo, jk, jv = jax.jit(functools.partial(jpaa, jm))(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(ids), jnp.asarray(offs),
        jnp.asarray(mask), jnp.asarray(base), jnp.asarray(lens))
    n_r = tm.size
    ss = nblk // n_r
    ks = [torch.from_numpy(kp[r * ss:(r + 1) * ss].copy())
          for r in range(n_r)]
    vs = [torch.from_numpy(vp[r * ss:(r + 1) * ss].copy())
          for r in range(n_r)]
    tid = torch.from_numpy(ids).long()
    rows = (tid >= 0).nonzero()[:, 0]
    app = rank_appends(rows, tid[rows], torch.from_numpy(offs).long()[rows],
                       [ss] * n_r)
    to = paged_attend_append(tm, torch.from_numpy(q), torch.from_numpy(kn),
                             torch.from_numpy(vn), ks, vs, app,
                             torch.from_numpy(mask), torch.from_numpy(base),
                             torch.from_numpy(lens), page=page)
    out[name] = {
        "out_err": float(np.abs(to.numpy() - np.asarray(jo)).max()),
        "k_same": bool(np.array_equal(torch.cat(ks).numpy(),
                                      np.asarray(jk))),
        "v_same": bool(np.array_equal(torch.cat(vs).numpy(),
                                      np.asarray(jv))),
        "finite": bool(torch.isfinite(to).all()),
        "empty_row": float(to[B - 1].abs().max()),
        "out_scale": float(np.abs(np.asarray(jo)).max())}
print("RESULTS:" + json.dumps(out))
"""


@pytest.mark.mesh
def test_paged_attend_append_matches_reference_shard_map(tmp_path):
    """The mesh branch against the reference's ``shard_map``'d
    ``paged_attend_append`` over 8 forced JAX host devices, fp32: batch
    sharded with local mask columns (combine over ``model``), the same
    mesh with global columns (the replicated fallback, combine over
    every rank), a ``("model",)`` mesh (replicated) and a ``("data",)``
    mesh (each rank normalises its own rows).  The appends land bitwise;
    the outputs agree within ``OUT_ATOL``; the empty slot's row is 0."""
    res = run_device_subprocess(ATTEND_CHILD, tmp_path=tmp_path, timeout=600)
    assert len(res) == 4
    for name, r in res.items():
        assert r["k_same"] and r["v_same"], (name, r)
        assert r["finite"] and r["empty_row"] == 0, (name, r)
        assert r["out_err"] <= OUT_ATOL and r["out_scale"] > 0.1, (name, r)


def test_legacy_staging_leg_over_the_mesh(served):
    """``fused_staging=False`` (the seed's leg: the prefill's pages
    written straight into the K/V slabs, eager CoW work) over the (2, 4)
    mesh: tokens and each sequence's pages equal the single-device legacy
    engine's."""
    _, _, cfg, tmodel = served
    kw = dict(max_seqs=8, max_blocks_per_seq=8, num_slabs=4,
              fused_staging=False)
    one = ServingEngine(cfg, tmodel, device="cpu", **kw)
    srv = ServingEngine(cfg, tmodel, mesh=mesh_of("data x model"), **kw)
    assert "k_stage" not in srv.engine.group.names
    rng = np.random.default_rng(9)
    sids = [(one.add_request(p.copy()), srv.add_request(p.copy()))
            for p in (rng.integers(2, cfg.vocab_size, size=n).astype(
                np.int32) for n in (40, 70, 9))]
    for r in range(3):
        if r == 1:
            one.fork(sids[0][0], 1)
            srv.fork(sids[0][1], 1)
        one.decode_round()
        srv.decode_round()
    assert srv.tokens == one.tokens
    for a, s in sids:
        for ba, bs in zip(one.cache.blocks_of(a), srv.cache.blocks_of(s)):
            np.testing.assert_allclose(srv.engine.block("k", bs).numpy(),
                                       one.engine.block("k", ba).numpy(),
                                       atol=OUT_ATOL)


@pytest.mark.parametrize("mesh_name,batch", [("data x model", 8),
                                             ("data", 8), ("model", 8),
                                             ("data", 6)])
def test_make_serve_state_dp_matches_reference(mesh_name, batch):
    """``make_serve_state(mesh=)``'s ``dp``: the block table, share mask
    (local columns when the batch divides over (pod, data)) and base equal
    the reference's; the pools are one slab per rank.  ``decode_state``
    over the mesh decodes such a state (local columns included) as the
    single-device facade decodes the unsharded state, and refuses it
    without the mesh; where the shards do not divide the block count (6
    blocks over 4 ranks) it refuses, as the reference's ``shard_map``."""
    shape, axes = MESHES[mesh_name]
    jcfg = jget_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jst = build_model(jcfg).make_serve_state(batch, 64,
                                             jax_mesh_like(shape, axes))
    model = init_params(cfg, seed=0, device="cpu")
    mesh = mesh_of(mesh_name)
    st = model.make_serve_state(batch, 64, mesh)
    for k in ("block_table", "share_mask", "base"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    assert len(st["k_pools"]) == mesh.size
    toks = torch.arange(batch, dtype=torch.long) + 2
    if batch % mesh.size:
        with pytest.raises(ValueError, match="do not divide"):
            model.decode_state(st, toks, mesh=mesh)
        return
    if st["share_mask"].shape[1] != batch:
        with pytest.raises(ValueError, match="mesh"):
            model.decode_state(st, toks)
    got, _ = model.decode_state(st, toks, mesh=mesh)
    want, _ = model.decode_state(model.make_serve_state(batch, 64), toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OUT_ATOL)
