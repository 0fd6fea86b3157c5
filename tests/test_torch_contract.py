"""The port's host contract layer against the JAX package's.

* the opcode registry, field by field, and the configuration copy;
* PoolGroup bases/locate and allocator scripts give the same results;
* seeded random enqueue streams (the generators of
  ``test_dispatch_properties.py``) make both CommandQueues flush identical
  tables, row for row: WAR spacers, bucket padding, overflow chunks and
  hazard auto-flushes — compared through the journal rows and the padded
  length of every dispatched table.

The helpers here (numpy<->torch bridging, an engine of the port built on
the same bytes as a JAX engine, the program runner) are shared by the
other ``test_torch_*`` files.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from test_dispatch_properties import gen_program, mk_engine, run_program

import repro.configs as jcfg
import repro.core.allocator as jalloc
import repro.core.opcodes as jops
import repro.core.poolspec as jps
import repro_torch.configs as tcfg
import repro_torch.core.allocator as talloc
import repro_torch.core.opcodes as tops
import repro_torch.core.poolspec as tps
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.poolspec import BlockRef
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.kernels import fused_dispatch as tfd


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def to_torch(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor; bf16 crosses as uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def bits(x) -> np.ndarray:
    """Raw bytes of an array or tensor, for bitwise comparison (NaN bit
    patterns from AND/OR/NOT included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def port_engine_like(jeng) -> RowCloneEngine:
    """A port engine on the JAX engine's current bytes, allocator layout,
    staging map, block axis, drain path and ``max_requests``."""
    a = jeng.alloc
    alloc = SubarrayAllocator(a.num_blocks, a.num_slabs,
                              reserved_zero_per_slab=len(a.zero_rows)
                              // a.num_slabs)
    pools = {n: to_torch(p) for n, p in jeng.pools.items()}
    return RowCloneEngine(pools, alloc, block_axis=jeng.block_axis,
                          staging=dict(jeng.staging),
                          use_fused=jeng.use_fused,
                          max_requests=jeng.max_requests)


class PortHook:
    """Collect the port's dispatch events, like ``run_program``'s hook."""

    def __enter__(self):
        self.events = []
        self._fn = lambda n, p, mech: self.events.append((n, p, mech))
        tfd.add_launch_hook(self._fn)
        return self.events

    def __exit__(self, *exc):
        tfd.remove_launch_hook(self._fn)


def run_program_port(eng: RowCloneEngine, prog):
    """``run_program`` of test_dispatch_properties.py, on the port."""
    with PortHook() as events:
        with eng.batch():
            for instr in prog:
                if instr[0] == "copy":
                    eng.memcopy([tuple(p) for p in instr[1]])
                elif instr[0] == "zero":
                    eng.materialize_zeros(instr[1])
                elif instr[0] == "lazy":
                    eng.meminit(instr[1], lazy=True)
                elif instr[0] == "war":
                    eng.memcopy([tuple(p) for p in instr[1]])
                    if instr[2] is not None:
                        eng.materialize_zeros([instr[2]])
                elif instr[0] == "bit":
                    op, rows, mode = instr[1], instr[2], instr[3]
                    args = ([tuple(r) for r in rows] if mode == "int" else
                            [tuple(BlockRef(p, i) for p, i in r)
                             for r in rows])
                    getattr(eng, "mem" + op)(args)
                else:
                    sp, dp = instr[2], instr[3]
                    eng.memcopy_cross([(BlockRef(sp, s), BlockRef(dp, d))
                                       for s, d in instr[1]])
    return events


def assert_same_pools(jeng, teng, ctx=""):
    for name in jeng.pools:
        np.testing.assert_array_equal(bits(jeng.pools[name]),
                                      bits(teng.pools[name]),
                                      err_msg=f"pool {name} {ctx}")


def journal_rows(eng):
    return [(r.stream, r.index, tuple(tuple(x) for x in r.rows), r.launches,
             r.aborted) for r in eng.journal.records]


QUEUE_FIELDS = ("enqueued", "flushes", "hazard_flushes", "war_hazards",
                "spacer_rows", "launches", "retired", "max_pending")


def queue_stats(q):
    return {f: getattr(q.stats, f) for f in QUEUE_FIELDS}


def common_stats(jeng, teng):
    """EngineStats fields both engines keep (the port has no demotion)."""
    t = dataclasses.asdict(teng.stats)
    j = dataclasses.asdict(jeng.stats)
    return {k: j[k] for k in t}, t


@pytest.fixture
def one_thread():
    """Run the test's torch work on one CPU thread: under ``-n 6`` each
    worker's default pool (a thread a core) oversubscribes the cores and
    small training steps run many times slower; the reduced models gain
    nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def jax_and_port_models(arch: str, **overrides):
    """The reduced ``arch`` (with ``overrides``, e.g. ``dtype``) as a JAX
    model with ``init_params(jax.random.key(0))`` and the port's model on
    the CPU with the same weights (``from_jax_params``).  Returns (JAX
    model, JAX params, port model, port config)."""
    from repro.models import build_model, split_params
    from repro_torch.weights import from_jax_params
    jc = dataclasses.replace(jcfg.get_config(arch).reduced(), **overrides)
    tc = dataclasses.replace(tcfg.get_config(arch).reduced(), **overrides)
    jmodel = build_model(jc)
    params, _ = split_params(jmodel.init_params(jax.random.key(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, from_jax_params(tree, tc, device="cpu"), tc


#: the serve-state leaves the facades carry, by family
STATE_KEYS = {"ssm": ("conv_state", "ssm_state"),
              "hybrid": ("conv_state", "ssm_state", "k_pools", "v_pools"),
              "vlm": ("k_pools", "v_pools"),
              "encdec": ("k_pools", "v_pools", "cross_k", "cross_v")}


def facade_parity(jmodel, params, tmodel, cfg, prompts, steps: int = 4, *,
                  logit_atol: float, state_atol: float, patches=None,
                  src=None):
    """``prefill_state`` then ``steps`` greedy ``decode_state`` calls of the
    port against the JAX facade's ``prefill`` / ``decode_step`` on the same
    prompts (and, for vlm, the same ``patches`` as ``patch_embeds``; for
    encdec, the same ``src`` frames as ``src_embeds``):
    logits within ``logit_atol`` at every call, identical greedy tokens
    (both sides are fed the reference's token), and the state's recurrent
    leaves and KV pools within ``state_atol`` (same layout as the
    reference) after the prefill and after the last step."""
    import jax.numpy as jnp

    def same_state(sj, st, when):
        assert sorted(st) == sorted(sj), when
        for key in ("seq_lens", "block_table", "share_mask", "base"):
            if key in sj:
                np.testing.assert_array_equal(st[key].numpy(),
                                              np.asarray(sj[key]),
                                              err_msg=f"{key} {when}")
        for key in STATE_KEYS[cfg.family]:
            assert tuple(st[key].shape) == tuple(sj[key].shape), key
            np.testing.assert_allclose(
                st[key].float().numpy(),
                np.asarray(sj[key]).astype(np.float32), atol=state_atol,
                rtol=1e-4, err_msg=f"{key} {when}")

    batch = {"tokens": jnp.asarray(prompts)}
    extra = {}
    for name, a in (("patch_embeds", patches), ("src_embeds", src)):
        if a is not None:
            batch[name] = jnp.asarray(a)
            extra[name] = torch.from_numpy(a)
    lj, sj = jmodel.prefill(params, batch, None)
    lt, st = tmodel.prefill_state(torch.from_numpy(prompts).long(), **extra)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=logit_atol)
    same_state(sj, st, "after prefill")
    for step in range(steps):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(lt.argmax(-1).numpy(), tok,
                                      err_msg=f"greedy token, step {step}")
        lj, sj = jmodel.decode_step(params, sj, jnp.asarray(tok), None)
        lt, st = tmodel.decode_state(st,
                                     torch.from_numpy(tok.copy()).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=logit_atol,
                                   err_msg=f"decode step {step}")
    same_state(sj, st, f"after {steps} decode steps")


# ---------------------------------------------------------------------------
# registry and configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(jops.OPCODES))
def test_opcode_spec_matches_reference(op):
    assert dataclasses.asdict(tops.OPCODES[op]) == \
        dataclasses.asdict(jops.OPCODES[op])


def test_opcode_tables_match_reference():
    assert sorted(tops.OPCODES) == sorted(jops.OPCODES)
    for name in ("OPCODE_NAMES", "CONSTANT_NAMES", "BITWISE_OPS",
                 "PLAIN_COPY_OPS", "MAX_PACK_BLOCKS", "ALL_PRIMARY"):
        assert getattr(tops, name) == getattr(jops, name), name
    for a, b, total in ((0, 0, 1), (5, 7, 100), (46339, 46338, 46340)):
        packed = tops.pack_bitwise_src(a, b, total)
        assert packed == jops.pack_bitwise_src(a, b, total)
        assert tops.unpack_bitwise_src(packed, total) == (a, b)
    with pytest.raises(ValueError):
        tops.check_pack_total(tops.MAX_PACK_BLOCKS + 1)


#: the registry entries the port runs: every config of the reference
PORTED_ARCHS = ("llama3.2-3b", "yi-6b", "mistral-nemo-12b", "qwen2-72b",
                "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "paligemma-3b",
                "mamba2-780m", "zamba2-2.7b", "seamless-m4t-medium")
#: properties, and methods called without arguments
CONFIG_PROPS = ("padded_vocab", "q_dim", "kv_dim", "num_attn_layers",
                "ssm_d_inner", "is_attention_free", "has_subquadratic_path",
                "param_count", "active_param_count")


def _prop(cfg, name):
    value = getattr(cfg, name)
    return value() if callable(value) else value


def test_config_copy_matches_reference():
    assert sorted(tcfg._REGISTRY) == sorted(PORTED_ARCHS)
    for arch in PORTED_ARCHS:
        full_t = tcfg.get_config(arch)
        full_j = jcfg.get_config(arch)
        for t, j in ((full_t, full_j), (full_t.reduced(), full_j.reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            for prop in CONFIG_PROPS:
                assert _prop(t, prop) == _prop(j, prop), (arch, prop)
    rt = dataclasses.asdict(tcfg.RowCloneConfig())
    rj = dataclasses.asdict(jcfg.RowCloneConfig())
    assert rt == {k: rj[k] for k in rt}
    # the training hyper-parameters and the input shapes, field for field
    assert dataclasses.asdict(tcfg.TrainConfig()) == \
        dataclasses.asdict(jcfg.TrainConfig())
    assert [f.name for f in dataclasses.fields(tcfg.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.TrainConfig)]
    assert sorted(tcfg.SHAPES) == sorted(jcfg.SHAPES)
    for name, shape in tcfg.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jcfg.SHAPES[name])
        for arch in PORTED_ARCHS:
            assert tcfg.shape_applicable(tcfg.get_config(arch), shape) == \
                jcfg.shape_applicable(jcfg.get_config(arch),
                                      jcfg.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_family_sizes_pinned(arch):
    """The sizes the port's models are built from, full and reduced: the
    KV-owning layers (0 for ssm, one per shared-attention segment for
    hybrid, the decoder layers for encdec), d_inner, the padded vocabulary
    and the parameter counts (all and active, in millions), as the
    reference reports them and as the published configurations give
    them."""
    want = {"llama3.2-3b": (28, 6144, 128256, 3212, 3212),
            "yi-6b": (32, 8192, 64000, 6061, 6061),
            "mistral-nemo-12b": (40, 10240, 131072, 12247, 12247),
            "qwen2-72b": (80, 16384, 152064, 72706, 72706),
            "deepseek-moe-16b": (28, 4096, 102400, 16879, 2830),
            "phi3.5-moe-42b-a6.6b": (32, 8192, 32256, 41874, 6641),
            "paligemma-3b": (18, 4096, 257280, 2508, 2508),
            "mamba2-780m": (0, 3072, 50432, 780, 780),
            "zamba2-2.7b": (9, 5120, 32000, 2422, 2422),
            "seamless-m4t-medium": (12, 2048, 256256, 977, 977)}[arch]

    def sizes(cfg):
        return (cfg.num_attn_layers, cfg.ssm_d_inner, cfg.padded_vocab,
                cfg.param_count() // 10**6, cfg.active_param_count() // 10**6)

    t, j = tcfg.get_config(arch), jcfg.get_config(arch)
    assert sizes(t) == want
    for cfg in (t, t.reduced()):
        ref = j if cfg is t else j.reduced()
        assert sizes(cfg) == sizes(ref)


def test_family_kv_layers_and_params_match_reference():
    """The encdec counts its decoder layers as KV-owning and adds the
    encoder and the cross-attention to its parameters, as the reference
    does, also for a dense config recast as encdec (977,858,560 for
    seamless-m4t-medium); moe and vlm: every layer owns a KV cache, as the
    reference counts it."""
    for cfg_t, cfg_j in ((tcfg.get_config("seamless-m4t-medium"),
                          jcfg.get_config("seamless-m4t-medium")),
                         *((dataclasses.replace(c.get_config("llama3.2-3b"),
                                                family="encdec",
                                                encoder_layers=3)
                            for c in (tcfg, jcfg)),)):
        for t, j in ((cfg_t, cfg_j), (cfg_t.reduced(), cfg_j.reduced())):
            assert t.num_attn_layers == j.num_attn_layers == t.num_layers
            assert t.param_count() == j.param_count()
    assert tcfg.get_config("seamless-m4t-medium").param_count() == \
        977_858_560
    for arch, fam in (("deepseek-moe-16b", "moe"),
                      ("phi3.5-moe-42b-a6.6b", "moe"),
                      ("paligemma-3b", "vlm")):
        t, j = tcfg.get_config(arch), jcfg.get_config(arch)
        assert t.family == fam
        assert t.num_attn_layers == j.num_attn_layers == t.num_layers


# ---------------------------------------------------------------------------
# address space and allocator
# ---------------------------------------------------------------------------

GROUPS = [
    [("k", 16, "primary"), ("v", 16, "primary")],
    [("k", 32, "primary"), ("v", 32, "primary"), ("k_stage", 8, "staging"),
     ("v_stage", 8, "staging")],
    [("a", 4, "primary"), ("s", 3, "staging")],
]


@pytest.mark.parametrize("layout", GROUPS)
def test_poolgroup_matches_reference(layout):
    def build(mod):
        specs = []
        for name, n, role in layout:
            paired = None if role == "primary" else name.split("_")[0] \
                if "_" in name else "a"
            specs.append(mod.PoolSpec(name, n, role=role, paired=paired))
        return mod.PoolGroup(specs)

    t, j = build(tps), build(jps)
    assert t.bases == j.bases and t.total_blocks == j.total_blocks
    assert t.primary == j.primary and t.staging_map == j.staging_map
    for gid in range(t.total_blocks):
        assert t.locate(gid) == j.locate(gid)
    for name, n, _ in layout:
        for b in range(n):
            assert t.gid(tps.BlockRef(name, b)) == \
                j.gid(jps.BlockRef(name, b))
    with pytest.raises(ValueError):
        t.locate(t.total_blocks)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_script_matches_reference(seed):
    rng = random.Random(seed)
    t = talloc.SubarrayAllocator(64, 4, reserved_zero_per_slab=1)
    j = jalloc.SubarrayAllocator(64, 4, reserved_zero_per_slab=1)
    live = []
    for _ in range(200):
        verb = rng.choice(["alloc", "near", "share", "free", "zero",
                           "written"])
        if verb == "alloc" and t.total_free() > 4:
            n, slab = rng.randint(1, 3), rng.choice([None, 0, 1, 2, 3])
            got = t.alloc(n, prefer_slab=slab)
            assert got == j.alloc(n, prefer_slab=slab)
            live += got
        elif verb == "near" and live and t.total_free() > 1:
            src = rng.choice(live)
            got = t.alloc_near(src)
            assert got == j.alloc_near(src)
            live.append(got)
        elif verb == "share" and live:
            ids = rng.sample(live, min(2, len(live)))
            t.share(ids)
            j.share(ids)
            live += ids
        elif verb == "free" and live:
            b = live.pop(rng.randrange(len(live)))
            t.free([b])
            j.free([b])
        elif verb in ("zero", "written") and live:
            ids = rng.sample(live, 1)
            getattr(t, "mark_" + verb)(ids)
            getattr(j, "mark_" + verb)(ids)
    np.testing.assert_array_equal(t.refcount, j.refcount)
    np.testing.assert_array_equal(t.is_zero, j.is_zero)
    assert t._free == j._free
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)


# ---------------------------------------------------------------------------
# flushed tables, row for row
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10**6), st.integers(0, 1), st.integers(1, 8),
       st.integers(0, 2))
def test_queue_flushes_identical_tables(seed, block_axis, n_instr,
                                        stage_shift):
    """Random streams over heterogeneous pools: both queues flush the same
    spaced rows (journal), pad them to the same buckets (dispatch events),
    and count the same hazards, spacers and launches; the engines end with
    the same stats and bitwise-equal pools."""
    rng = random.Random(seed)
    nblk = rng.choice([32, 64])
    stage_nblk = nblk >> stage_shift
    prog = gen_program(rng, nblk, n_instr, stage_nblk=stage_nblk)
    jeng = mk_engine(nblk, block_axis, use_fused=True, stage_nblk=stage_nblk)
    teng = port_engine_like(jeng)
    ev_j = run_program(jeng, prog)
    ev_t = run_program_port(teng, prog)
    assert ev_t == ev_j, (seed, prog)
    assert journal_rows(teng) == journal_rows(jeng)
    assert queue_stats(teng.queue) == queue_stats(jeng.queue)
    np.testing.assert_array_equal(teng.alloc.is_zero, jeng.alloc.is_zero)
    j_stats, t_stats = common_stats(jeng, teng)
    assert t_stats == j_stats
    assert_same_pools(jeng, teng, f"(seed={seed})")


def test_overflow_chunks_match_reference():
    """More than 512 commands in one flush drain in the same two chunks."""
    jeng = mk_engine(2048, 0, use_fused=True)
    teng = port_engine_like(jeng)
    pairs = [(i, 1024 + i) for i in range(600)]
    prog = [["copy", [list(p) for p in pairs]],
            ["zero", list(range(700, 720))]]
    for eng in (jeng, teng):
        eng.alloc.mark_written([s for s, _ in pairs])
    ev_j = run_program(jeng, prog)
    ev_t = run_program_port(teng, prog)
    assert ev_t == ev_j
    assert [n for n, _, _ in ev_t] == [512, 128]
    assert journal_rows(teng) == journal_rows(jeng)
    assert_same_pools(jeng, teng, "(overflow)")


def test_retire_rebuilds_hazard_maps_like_reference():
    """retire() removes each requested row once and rebuilds the pending
    source/destination maps from the survivors, as the reference."""
    jeng = mk_engine(32, 1, use_fused=True, stage_nblk=8)
    teng = port_engine_like(jeng)
    for eng in (jeng, teng):
        slots = eng.stage_blocks(3)
        s = eng.stream("lane")
        s.promote_staged([(slot, 10 + i) for i, slot in enumerate(slots)])
        assert eng.retire_promotions([(slots[1], 11)]) == 2
    assert teng.stage_slots_free == jeng.stage_slots_free
    assert teng._stage_free == jeng._stage_free
    jq = next(iter(jeng._live_queues.values()))
    tq = next(iter(teng._live_queues.values()))
    assert tq.pending == jq.pending
    assert tq._pending_srcs == jq._pending_srcs
    assert tq._pending_dsts == jq._pending_dsts
    assert queue_stats(tq) == queue_stats(jq)


_ = jax  # JAX stays on the CPU (tests/conftest.py)
