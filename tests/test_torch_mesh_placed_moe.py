"""The moe decoder's serving weights placed over a rank mesh
(``weights.place_params``) against the JAX package, on the CPU.

ONE subprocess with 8 forced JAX host devices (marker ``mesh``) holds,
for the reduced deepseek-moe-16b with its published routing (64 experts,
top 6, one shared expert) over (2, 4) and (1, 8) ranks of ``("data",
"model")`` and over ``("data",)`` 8, the stock reduced deepseek-moe-16b
(4 experts, which 8 ``model`` ranks do not divide, so ``ffn`` takes
``model``) over (1, 8), and the reduced phi3.5-moe (no shared expert) over
(2, 4):

* (a) every placed weight's block on every rank, the router, the experts
  and the shared experts included, equals, bitwise, the reference's
  ``addressable_shards`` of ``tree_shardings(mesh, params, axes)`` for
  that device;
* (b) ``prefill(mesh=)`` and three ``decode_step(mesh=)`` of the placed
  model against the reference's ``jax.jit(model.prefill / decode_step,
  in_shardings=(p_sh, ...))``: logits within ``LOGIT_ATOL``, K/V within
  ``KV_ATOL``, equal greedy tokens, and in every call the moe path the
  reference's ``moe_ffn`` takes in every layer (``moe.PATH_COUNTS``): the
  all-to-all at a length ``model`` divides, the local path at the odd
  length 37, in decode and wherever the experts do not divide ``model``,
  the FSDP path (d) over ``("data",)`` 8 at B = 8.

In this process: (c) ``ServingEngine(mesh=)`` over the placed reduced
deepseek decodes the unplaced mesh engine's tokens over 4 rounds with a
fork, at most one fused drain a round, every moe call on the local path;
(e) ``moe.RouteLog`` matches the routes of a placed model's batch groups
to one device's calls by rows, counting no flip and replaying them.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _meshproc import run_device_subprocess

from repro_torch.configs import get_config
from repro_torch.kernels.fused_dispatch import (add_launch_hook,
                                                remove_launch_hook)
from repro_torch.launch.mesh import (Sharded, Sharding, gather,
                                     make_test_mesh, map_blocks, rank_bytes)
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import moe
from repro_torch.models.lm import PLACED_FAMILIES
from repro_torch.sharding.rules import logical_to_spec
from repro_torch.weights import init_params, place_params

#: bf16 heads (as tests/test_torch_mesh_placed.py); fp32 K/V and moe
#: outputs of another summation order
LOGIT_ATOL, KV_ATOL, MOE_ATOL = 4e-3, 1e-4, 1e-4

#: the published routing of deepseek-moe-16b on its reduced config
PUBLISHED = {"num_experts": 64, "top_k": 6}
#: name -> (arch, config changes, mesh shape, mesh axes, batch, prompt
#: lengths, the path of each length's prefill, the decode's path)
CASES = {
    "deepseek 64, (2, 4)": ("deepseek-moe-16b", PUBLISHED, (2, 4),
                            ("data", "model"), 4, (48, 37),
                            ("a2a", "local"), "local"),
    "deepseek 64, (1, 8)": ("deepseek-moe-16b", PUBLISHED, (1, 8),
                            ("data", "model"), 4, (48, 37),
                            ("a2a", "local"), "local"),
    "deepseek 4, (1, 8)": ("deepseek-moe-16b", {}, (1, 8),
                           ("data", "model"), 4, (48,), ("local",),
                           "local"),
    "phi3.5, (2, 4)": ("phi3.5-moe-42b-a6.6b", {}, (2, 4),
                       ("data", "model"), 4, (48, 37), ("a2a", "local"),
                       "local"),
    "deepseek 64, data 8": ("deepseek-moe-16b", PUBLISHED, (8,), ("data",),
                            8, (48,), ("fsdp",), "fsdp"),
}

CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

import repro.models.moe as jmoe
from repro.configs import get_config as jget_config
from repro.launch.mesh import sharding_for as jsharding_for
from repro.launch.mesh import tree_shardings as jtree_shardings
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Sharded, make_test_mesh
from repro_torch.models import moe
from repro_torch.models.lm import _page_writer, kv_to_pools, paged_state
from repro_torch.weights import from_jax_params, jax_path, place_params

torch.set_num_threads(1)
cases = json.loads(sys.argv[1])
STEPS = 3

# the reference's moe path in each traced call (its layers are one scan
# body), in call order: a fallback to the local path replaces the mesh
# path that made it
seen = []
def spy(name, fn):
    def wrapped(params, x, cfg, mesh):
        if name == "local" and mesh is not None:
            seen[-1] = "local"
        elif name != "local":
            seen.append(name)
        return fn(params, x, cfg, mesh)
    return wrapped
jmoe._moe_ffn_local = spy("local", jmoe._moe_ffn_local)
jmoe._moe_ffn_a2a = spy("a2a", jmoe._moe_ffn_a2a)
jmoe._moe_ffn_fsdp = spy("fsdp", jmoe._moe_ffn_fsdp)

def err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())

def traced(fn):
    # the paths the reference's trace of ``fn`` took, and its result
    del seen[:]
    out = fn()
    return list(seen), out

out = {}
for cname, (arch, change, shape, mesh_axes, B, lens, _, _) in cases.items():
    jc = dataclasses.replace(jget_config(arch).reduced(), **change)
    tc = dataclasses.replace(get_config(arch).reduced(), **change)
    jmodel = build_model(jc)
    params, axes = split_params(jmodel.init_params(jax.random.key(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    n = int(np.prod(shape))
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(mesh_axes))
    tm = make_test_mesh(tuple(shape), tuple(mesh_axes), devices="cpu")
    rank_of = {d.id: r for r, d in enumerate(jm.devices.flat)}
    p_sh = jtree_shardings(jm, params, axes)
    pj = jax.device_put(params, p_sh)
    model = place_params(from_jax_params(tree, tc, device="cpu"), tm)
    # (a) every rank's block against the reference's shard on its device
    rec = {"checked": 0, "differ": [], "weights": 0, "split": [],
           "specs": {}}
    for name, v in model.placement.values.items():
        path, idx = jax_path(name)
        leaf = pj
        for key in path:
            leaf = leaf[key]
        rec["weights"] += 1
        if isinstance(v, Sharded):
            rec["split"].append(name)
        if name.startswith("layers.0.moe."):
            rec["specs"][name[len("layers.0.moe."):]] = \
                list(v.sharding.spec) if isinstance(v, Sharded) else None
        for shard in leaf.addressable_shards:
            r = rank_of[shard.device.id]
            want = np.asarray(shard.data)
            want = want if idx is None else want[idx]
            got = v.blocks[v.sharding.block_of(r)] \
                if isinstance(v, Sharded) else v
            rec["checked"] += 1
            if tuple(got.shape) != want.shape or \
                    not np.array_equal(got.numpy(), want):
                rec["differ"].append([name, r])
    out[cname] = rec
    # (b) prefill and decode_step against the jitted sharded reference
    for S in lens:
        rng = np.random.default_rng(S)
        prompts = rng.integers(2, tc.vocab_size, (B, S)).astype(np.int32)
        b_sh = {"tokens": jsharding_for(jm, (B, S), ("batch", None))}
        prefill = jax.jit(lambda p, b: jmodel.prefill(p, b, jm),
                          in_shardings=(p_sh, b_sh))
        with jm:
            ref_paths, (lj, sj) = traced(lambda: prefill(pj, jax.device_put(
                {"tokens": jnp.asarray(prompts)}, b_sh)))
        moe.PATH_COUNTS.clear()
        lt, kt, vt = model.prefill(torch.from_numpy(prompts).long(),
                                   mesh=tm)
        page = model.page
        nper = (S + page + page - 1) // page
        rec = {"logit_err": [err(lt.numpy(), lj)], "tokens_equal": True,
               "ref_paths": [ref_paths],
               "port_paths": [dict(moe.PATH_COUNTS)]}
        k = torch.cat(kt, dim=1)
        v = torch.cat(vt, dim=1)
        rec["kv_err"] = [err(kv_to_pools(t, page, torch.float32,
                                         nper).numpy(), sj[nm])
                         for t, nm in ((k, "k_pools"), (v, "v_pools"))]
        state = paged_state(tc, B, nper * page, page, tm, torch.float32,
                            "cpu")
        write = _page_writer(state, page, nper)
        for li in range(tc.num_layers):
            write(li, k[li], v[li])
        st_ax = jmodel.state_logical_axes(sj)
        st_sh = {key: jsharding_for(jm, x.shape, st_ax[key])
                 for key, x in sj.items()}
        tok_sh = jsharding_for(jm, (B,), ("batch",))
        decode = jax.jit(lambda p, s, t: jmodel.decode_step(p, s, t, jm),
                         in_shardings=(p_sh, st_sh, tok_sh))
        seq = torch.full((B,), S, dtype=torch.int32)
        for step in range(STEPS):
            tok = np.asarray(jnp.argmax(lj, -1), np.int32)
            rec["tokens_equal"] &= bool(np.array_equal(
                lt.argmax(-1).numpy(), tok))
            with jm:
                paths, (lj, sj) = traced(lambda: decode(
                    pj, jax.device_put(sj, st_sh),
                    jax.device_put(jnp.asarray(tok), tok_sh)))
            if paths:      # the jitted step traces once
                rec["ref_paths"].append(paths)
            moe.PATH_COUNTS.clear()
            lt = model.decode_step(
                torch.from_numpy(tok).long(), seq, state["k_pools"],
                state["v_pools"], state["block_table"], state["share_mask"],
                state["base"], mesh=tm)
            rec["port_paths"].append(dict(moe.PATH_COUNTS))
            seq = seq + 1
            rec["logit_err"].append(err(lt.numpy(), lj))
        rec["tokens_equal"] &= bool(np.array_equal(
            lt.argmax(-1).numpy(), np.asarray(jnp.argmax(lj, -1))))
        rec["slab_err"] = [err(torch.cat(state[nm], dim=1).numpy(), sj[nm])
                           for nm in ("k_pools", "v_pools")]
        out[f"{cname} / S {S}"] = rec
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_device_subprocess(
        CHILD, args=[json.dumps(CASES)],
        tmp_path=tmp_path_factory.mktemp("placed_moe"), timeout=1200)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's torch work on one CPU thread (as ``one_thread`` of
    test_torch_contract.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, change):
    return dataclasses.replace(get_config(arch).reduced(), **change)


#: each case's expert-matrix spec (w_gate, w_down) and router spec:
#: ``experts`` over ``model`` where E divides it, else ``ffn``; a router
#: that no axis of more than one rank splits stays whole (None)
SPECS = {
    "deepseek 64, (2, 4)": (["model", "data", None], ["model", None, "data"],
                            ["data", "model"]),
    "deepseek 64, (1, 8)": (["model", "data", None], ["model", None, "data"],
                            ["data", "model"]),
    "deepseek 4, (1, 8)": ([None, "data", "model"], [None, "model", "data"],
                           None),
    "phi3.5, (2, 4)": (["model", "data", None], ["model", None, "data"],
                       ["data", "model"]),
    "deepseek 64, data 8": ([None, "data", None], [None, None, "data"],
                            ["data", None]),
}


@pytest.mark.mesh
@pytest.mark.parametrize("case", list(CASES))
def test_placed_moe_blocks_equal_reference_shards(results, case):
    """(a) Every rank's block of every placed weight equals, bitwise, the
    reference's shard on that rank's device (8 shards a weight), in the
    experts-split and the ffn-split layouts; every expert and
    shared-expert matrix is split, and the router where its spec splits
    it."""
    r = results[case]
    assert r["differ"] == [] and r["checked"] == 8 * r["weights"], r
    gate, down, router = SPECS[case]
    assert r["specs"]["w_gate"] == r["specs"]["w_up"] == gate, r
    assert r["specs"]["w_down"] == down and r["specs"]["router"] == router
    arch, change = CASES[case][:2]
    cfg = _cfg(arch, change)
    mats = ("w_gate", "w_up", "w_down") + (("router",) if router else ())
    moe_names = [f"layers.{i}.moe.{w}" for i in range(cfg.num_layers)
                 for w in mats]
    if cfg.num_shared_experts:
        moe_names += [f"layers.{i}.moe.shared.{w}"
                      for i in range(cfg.num_layers)
                      for w in ("w_gate", "w_up", "w_down")]
    assert set(moe_names) <= set(r["split"]), r


def _lens():
    return [(c, S) for c in CASES for S in CASES[c][5]]


@pytest.mark.mesh
@pytest.mark.parametrize("case,S", _lens())
def test_placed_moe_prefill_and_decode_match_reference(results, case, S):
    """(b), (d) The placed ``prefill`` and three ``decode_step``s against
    the reference's jitted calls on the placed weights: logits within
    ``LOGIT_ATOL`` at every call, the prefill's K/V and the slabs after
    the steps within ``KV_ATOL``, equal greedy tokens, and in every call
    every layer takes the reference's moe path (the all-to-all where S
    and E divide ``model``, the local path at S = 37, in decode and for
    4 experts over 8 ranks, the FSDP path over ``("data",)`` 8)."""
    r = results[f"{case} / S {S}"]
    arch, change, *_, lens, prefill_paths, decode_path = CASES[case]
    L = _cfg(arch, change).num_layers
    want = prefill_paths[lens.index(S)]
    assert r["tokens_equal"], r
    assert max(r["logit_err"]) <= LOGIT_ATOL, r
    assert max(r["kv_err"] + r["slab_err"]) <= KV_ATOL, r
    # the reference scans its layers: one traced moe call for all of them
    assert r["ref_paths"] == [[want], [decode_path]], r
    assert r["port_paths"] == [{want: L}] + [{decode_path: L}] * 3, r


DS64 = ("deepseek-moe-16b", PUBLISHED)


def _engine_run(model, mesh, prompts, events):
    eng = ServingEngine(model.cfg, model, mesh=mesh, max_seqs=4,
                        max_blocks_per_seq=4, num_slabs=4)
    moe.PATH_COUNTS.clear()
    sids = [eng.add_request(p) for p in prompts]
    drains = []
    for rnd in range(4):
        if rnd == 1:
            eng.fork(sids[0], 1)
        e0 = len(events)
        eng.decode_round()
        drains.append(events[e0:])
    return eng, drains, dict(moe.PATH_COUNTS)


def test_placed_moe_engine_decodes_like_unplaced_mesh_engine():
    """(c) The placed reduced deepseek (64 experts, top 6) in
    ``ServingEngine(mesh=)`` over (2, 4) against the unplaced model's
    engine over the same mesh: three prompts (one of an odd length), a
    fork, 4 rounds: the same tokens, last logits within ``LOGIT_ATOL``, at
    most one ``fused_mesh`` drain a round, every moe call of the
    admissions (B = 1) and rounds on the local path; each rank holds an
    eighth of every expert matrix's bytes."""
    assert "moe" in PLACED_FAMILIES
    cfg = _cfg(*DS64)
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 70, 33)]
    events = []
    hook = lambda n, p, mech: events.append(mech)
    add_launch_hook(hook)
    try:
        whole, _, whole_paths = _engine_run(
            init_params(cfg, seed=0, device="cpu"), mesh, prompts, events)
        model = place_params(init_params(cfg, seed=0, device="cpu"), mesh)
        placed, drains, paths = _engine_run(model, mesh, prompts, events)
    finally:
        remove_launch_hook(hook)
    assert placed.tokens == whole.tokens
    for sid in whole.tokens:
        np.testing.assert_allclose(placed.last_logits[sid],
                                   whole.last_logits[sid], atol=LOGIT_ATOL)
    assert all(d in ([], ["fused_mesh"]) for d in drains), drains
    calls = cfg.num_layers * (len(prompts) + 4)
    assert paths == whole_paths == {"local": calls}, paths
    for name, v in model.placement.values.items():
        if v.ndim == 3:
            assert isinstance(v, Sharded), name
            assert rank_bytes([v], mesh) == [v.shape.numel() * 4 // 8] * 8


def test_placed_moe_layer_matches_unplaced_paths():
    """The placed moe FFN of one layer on every path against the unplaced
    ``moe_ffn`` over the same mesh on the same weights (``MOE_ATOL``):
    the experts-split local path (B = 1, and the decode's one position),
    the ffn-split local path (4 experts over 8 ``model`` ranks), the local
    path on experts split over neither (B = 1 over ``("data",)`` 8, the
    weights gathered whole), the FSDP path and the all-to-all."""
    dm, paths = ("data", "model"), []
    for change, shape, axes, B, S in (
            (PUBLISHED, (2, 4), dm, 1, 48), (PUBLISHED, (2, 4), dm, 4, 1),
            ({}, (1, 8), dm, 4, 48), (PUBLISHED, (8,), ("data",), 1, 48),
            (PUBLISHED, (8,), ("data",), 8, 4),
            (PUBLISHED, (2, 4), dm, 4, 48)):
        cfg = _cfg("deepseek-moe-16b", change)
        mesh = make_test_mesh(shape, axes, devices="cpu")
        whole = init_params(cfg, seed=0, device="cpu")
        model = place_params(init_params(cfg, seed=0, device="cpu"), mesh)
        x = torch.from_numpy(np.random.default_rng(S).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        sh = Sharding(mesh, logical_to_spec(("batch", "act_seq_tp", None),
                                            mesh, dims=tuple(x.shape)))
        moe.PATH_COUNTS.clear()
        want, _ = moe.moe_ffn(whole.layers[0].moe, x, cfg, mesh)
        # laid out as a placed model's residual: a Sharded even where the
        # spec splits nothing
        hx = map_blocks(sh, x.shape, lambda b, sl, r: x[sl].clone())
        got = moe.moe_ffn_placed(model.layers[0].moe, hx, cfg, sh)
        assert got.sharding == sh
        assert len(moe.PATH_COUNTS) == 1, moe.PATH_COUNTS
        paths.append(next(iter(moe.PATH_COUNTS)))
        np.testing.assert_allclose(gather(got).numpy(), want.numpy(),
                                   atol=MOE_ATOL)
    assert paths == ["local"] * 4 + ["fsdp", "a2a"]


def test_route_log_matches_placed_groups_by_rows():
    """(e) ``moe.RouteLog`` recorded over one device's prefill (B = 4,
    the odd length 37: the local path), then compared
    over the placed model's prefill over (2, 4), whose two batch groups
    route their rows apart (two calls a layer for one device's one):
    every recorded row is matched, no flip; ``replay`` routes by the recorded
    choices and gives the same logits; a call that matches no recorded
    rows raises."""
    cfg = _cfg(*DS64)
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    one = init_params(cfg, seed=0, device="cpu")
    model = place_params(init_params(cfg, seed=0, device="cpu"), mesh)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        2, cfg.vocab_size, (4, 37)))
    log = moe.RouteLog(cfg.num_experts)

    def run(m, mesh_):
        moe.ROUTE_HOOK = log
        try:
            return m.prefill(tokens, mesh=mesh_)[0]
        finally:
            moe.ROUTE_HOOK = None

    want = run(one, None)
    assert [tuple(c.shape) for c in log.calls] == \
        [(4, 37, cfg.top_k)] * cfg.num_layers
    got = {}
    for mode in ("compare", "replay"):
        log.reset(mode)
        got[mode] = run(model, mesh)
        assert log.consumed() and log.flipped() == 0
        assert len(log.flips) == 2 * cfg.num_layers
        assert log.choices == tokens.numel() * cfg.top_k * cfg.num_layers
    assert torch.equal(got["compare"], got["replay"])
    np.testing.assert_allclose(got["compare"].numpy(), want.numpy(),
                               atol=LOGIT_ATOL)
    log.reset("compare")
    with pytest.raises(ValueError, match="matches no rows"):
        log(torch.zeros((4, 36, cfg.top_k), dtype=torch.long))


def test_route_log_maps_engine_slots():
    """(e) over engines: ``moe.RouteLog`` recorded over the single-device
    engine's admissions and 4 rounds (a fork before round 2), then
    compared over the placed engine's over (2, 4), whose batch groups
    hold the sequences in other slots and route apart: with each round's
    rows mapped through the two engines' slots (``map_rows``; a slot that
    holds no sequence is not compared), every recorded row is matched and
    no choice flips, and the two engines decode the same tokens."""
    cfg = _cfg(*DS64)
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 70, 33)]
    log = moe.RouteLog(cfg.num_experts)
    slots = {}

    def run(model, mesh_, rows=None):
        eng = ServingEngine(cfg, model, mesh=mesh_, max_seqs=4,
                            max_blocks_per_seq=4, num_slabs=4,
                            device="cpu")
        moe.ROUTE_HOOK = log
        try:
            sids = [eng.add_request(p) for p in prompts]
            for rnd in range(4):
                if rnd == 1:
                    eng.fork(sids[0], 1)
                if rows is not None:
                    log.map_rows(rows(eng))
                eng.decode_round()
        finally:
            moe.ROUTE_HOOK = None
        if rows is None:
            slots.update({s: eng.cache.slot_of(s) for s in eng.tokens})
        return eng.tokens

    want = run(init_params(cfg, seed=0, device="cpu"), None)

    def rows(eng):
        out = [-1] * 4
        for sid in eng.tokens:
            out[eng.cache.slot_of(sid)] = slots[sid]
        return out

    log.reset("compare")
    got = run(place_params(init_params(cfg, seed=0, device="cpu"), mesh),
              mesh, rows)
    assert got == want
    assert log.consumed() and log.flipped() == 0
    assert log.choices > 0


def test_place_params_releases_each_weight_as_it_goes(monkeypatch):
    """``place_params`` places a model in place one weight at a time: when
    it places the i-th parameter, the i before it are released (their
    blocks are copies), so the peak of placing is the model and one
    weight's blocks, not two copies (a moe model of 33.76 GB placed on one
    80 GB card beside its pools)."""
    import gc
    import weakref

    from repro_torch import weights
    cfg = _cfg(*DS64)
    model = init_params(cfg, seed=0, device="cpu")
    refs = [weakref.ref(p) for p in model.parameters()]
    alive = []
    place = weights.place

    def spy(x, sharding):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        return place(x, sharding)

    monkeypatch.setattr(weights, "place", spy)
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    weights.place_params(model, mesh)
    assert alive == [len(refs) - i for i in range(len(refs))]
