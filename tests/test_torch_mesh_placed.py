"""The dense decoder's serving weights placed over a rank mesh
(``weights.place_params``) against the JAX package, on the CPU.

ONE subprocess with 8 forced JAX host devices (marker ``mesh``) holds,
for the reduced llama3.2-3b over (2, 4) and (1, 8) ranks of ``("data",
"model")`` (4 query heads: the ``"heads"`` strategy over 4 ``model`` ranks,
``"seq"`` over 8):

* (a) every placed weight's block on every rank equals, bitwise, the
  reference's ``addressable_shards`` of ``tree_shardings(mesh, params,
  axes)`` for that device;
* (b) ``prefill(mesh=)`` and three ``decode_step(mesh=)`` of the placed
  model against the reference's ``jax.jit(model.prefill / decode_step,
  in_shardings=(p_sh, ...))``: logits within ``LOGIT_ATOL``, K/V (the
  prefill's stacks in the identity layout, the slabs after the steps)
  within ``KV_ATOL``, equal greedy tokens; at a prompt length the
  ``model`` axis divides and at an odd one (d), which the reference's
  divisibility rule leaves whole.

In this process: (c) ``ServingEngine(mesh=)`` over the placed model
decodes the unplaced mesh engine's tokens over 4 rounds with a fork, at
most one fused drain a round; (d) the odd-length rule; and K3's
``q_offset`` in its plain version against the reference's model-level
``flash_attention`` with ``pos_q`` offset, at D = 32 and 128 (fp32, atol
1e-4 as tests/test_torch_attention.py).  The facades' placed weights:
tests/test_torch_mesh_placed_facades.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _meshproc import run_device_subprocess

from repro.models.attention import MaskInfo
from repro.models.attention import flash_attention as jax_model_flash
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.fused_dispatch import (add_launch_hook,
                                                remove_launch_hook)
from repro_torch.launch.mesh import Sharded, make_test_mesh, rank_bytes
from repro_torch.launch.serve import ServingEngine
from repro_torch.sharding.rules import attn_strategy
from repro_torch.weights import init_params, place_params

#: bf16 heads (as tests/test_torch_mesh_model.py); fp32 K/V of another
#: summation order
LOGIT_ATOL, KV_ATOL = 4e-3, 1e-4

#: the meshes, by the strategy the reduced config's 4 heads take there
MESHES = {"heads (2, 4)": ((2, 4), ("data", "model")),
          "seq (1, 8)": ((1, 8), ("data", "model"))}
#: prompt lengths: one that 4 and 8 divide, and an odd one
LENS = (48, 37)

CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

from repro.configs import get_config as jget_config
from repro.launch.mesh import sharding_for as jsharding_for
from repro.launch.mesh import tree_shardings as jtree_shardings
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Sharded, make_test_mesh
from repro_torch.models.lm import _page_writer, kv_to_pools, paged_state
from repro_torch.weights import from_jax_params, jax_path, place_params

torch.set_num_threads(1)
meshes, lens = json.loads(sys.argv[1]), json.loads(sys.argv[2])
B, STEPS = 4, 3
jc = jget_config("llama3.2-3b").reduced()
tc = get_config("llama3.2-3b").reduced()
jmodel = build_model(jc)
params, axes = split_params(jmodel.init_params(jax.random.key(0)))
tree = jax.tree_util.tree_map(np.asarray, params)

offsets = []
flash = ops.flash_attention
def spy(*a, **kw):
    offsets.append(kw.get("q_offset", 0))
    return flash(*a, **kw)
ops.flash_attention = spy

def err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())

out = {}
for mname, (shape, mesh_axes) in meshes.items():
    n = int(np.prod(shape))
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(mesh_axes))
    tm = make_test_mesh(tuple(shape), tuple(mesh_axes), devices="cpu")
    rank_of = {d.id: r for r, d in enumerate(jm.devices.flat)}
    p_sh = jtree_shardings(jm, params, axes)
    pj = jax.device_put(params, p_sh)
    model = place_params(from_jax_params(tree, tc, device="cpu"), tm)
    # (a) every rank's block against the reference's shard on its device
    rec = {"checked": 0, "differ": [], "split": 0}
    for name, v in model.placement.values.items():
        path, idx = jax_path(name)
        leaf = pj
        for key in path:
            leaf = leaf[key]
        rec["split"] += isinstance(v, Sharded)
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
    out[mname] = rec
    # (b) prefill and decode_step against the jitted sharded reference
    st_ax = None
    for S in lens:
        rng = np.random.default_rng(S)
        prompts = rng.integers(2, tc.vocab_size, (B, S)).astype(np.int32)
        b_sh = {"tokens": jsharding_for(jm, (B, S), ("batch", None))}
        prefill = jax.jit(lambda p, b: jmodel.prefill(p, b, jm),
                          in_shardings=(p_sh, b_sh))
        with jm:
            lj, sj = prefill(pj, jax.device_put(
                {"tokens": jnp.asarray(prompts)}, b_sh))
        del offsets[:]
        lt, kt, vt = model.prefill(torch.from_numpy(prompts).long(),
                                   mesh=tm)
        page = model.page
        nper = (S + page + page - 1) // page
        rec = {"logit_err": [err(lt.numpy(), lj)], "tokens_equal": True,
               "groups": len(kt), "offsets": sorted(set(offsets)),
               "stack_shape": list(kt[0].shape)}
        k = torch.cat(kt, dim=1)
        v = torch.cat(vt, dim=1)
        rec["kv_err"] = [err(kv_to_pools(t, page, torch.float32,
                                         nper).numpy(), sj[n])
                         for t, n in ((k, "k_pools"), (v, "v_pools"))]
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
                lj, sj = decode(pj, jax.device_put(sj, st_sh),
                                jax.device_put(jnp.asarray(tok), tok_sh))
            lt = model.decode_step(
                torch.from_numpy(tok).long(), seq, state["k_pools"],
                state["v_pools"], state["block_table"], state["share_mask"],
                state["base"], mesh=tm)
            seq = seq + 1
            rec["logit_err"].append(err(lt.numpy(), lj))
        rec["tokens_equal"] &= bool(np.array_equal(
            lt.argmax(-1).numpy(), np.asarray(jnp.argmax(lj, -1))))
        rec["slab_err"] = [err(torch.cat(state[n], dim=1).numpy(), sj[n])
                           for n in ("k_pools", "v_pools")]
        out[f"{mname} / S {S}"] = rec
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_device_subprocess(
        CHILD, args=[json.dumps(MESHES), json.dumps(LENS)],
        tmp_path=tmp_path_factory.mktemp("placed"), timeout=900)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's torch work on one CPU thread (as ``one_thread`` of
    test_torch_contract.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(name):
    shape, axes = MESHES[name]
    return make_test_mesh(shape, axes, devices="cpu")


@pytest.mark.mesh
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placed_blocks_equal_reference_shards(results, mesh_name):
    """(a) Every rank's block of every placed weight equals, bitwise, the
    reference's shard on that rank's device: 38 weights (4 layers x 7
    matrices and 2 norms, the tied embedding, the final norm), 8 shards
    each.  Every weight is split over (2, 4); over (1, 8) the 9 norms,
    whose ``data`` axis has one rank, stay whole."""
    r = results[mesh_name]
    assert r["differ"] == [] and r["checked"] == 8 * 38, r
    assert r["split"] == (38 if mesh_name.startswith("heads") else 29), r


@pytest.mark.mesh
@pytest.mark.parametrize("S", LENS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placed_prefill_and_decode_match_reference(results, mesh_name, S):
    """(b), (d) The placed ``prefill`` and three ``decode_step``s against
    the reference's jitted calls on the placed weights: logits within
    ``LOGIT_ATOL`` at every call, the prefill's K/V and the slabs after
    the steps within ``KV_ATOL``, equal greedy tokens, for 4 prompts (8
    blocks, which the reference's ``shard_map`` needs 8 ranks to divide).
    The K/V stacks come one a batch group (2 over (2, 4), 1 over (1, 8));
    over (1, 8) a
    prompt of 48 runs ``"seq"`` attention in row blocks of 6 (K3's
    ``q_offset`` 0, 6, ..., 42), one of 37 whole (offset 0), as the
    reference's divisibility rule leaves it."""
    r = results[f"{mesh_name} / S {S}"]
    assert r["tokens_equal"], r
    assert max(r["logit_err"]) <= LOGIT_ATOL, r
    assert max(r["kv_err"] + r["slab_err"]) <= KV_ATOL, r
    groups = 2 if mesh_name.startswith("heads") else 1
    assert r["groups"] == groups and r["stack_shape"] == [4, 4 // groups, S,
                                                          4, 32], r
    if mesh_name.startswith("seq") and S % 8 == 0:
        assert r["offsets"] == list(range(0, S, S // 8)), r
    else:
        assert r["offsets"] == [0], r


def _engine_tokens(model, mesh, prompts, events):
    eng = ServingEngine(model.cfg, model, mesh=mesh, max_seqs=4,
                        max_blocks_per_seq=4, num_slabs=4)
    sids = [eng.add_request(p) for p in prompts]
    drains = []
    for rnd in range(4):
        if rnd == 1:
            eng.fork(sids[0], 1)
        e0 = len(events)
        eng.decode_round()
        drains.append(events[e0:])
    return eng, drains


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placed_engine_decodes_like_unplaced_mesh_engine(mesh_name):
    """(c) The placed model's ``ServingEngine(mesh=)`` against the unplaced
    model's over the same mesh: three prompts (one of an odd length), a
    fork, 4 rounds: the same tokens, last logits within ``LOGIT_ATOL``,
    at most one ``fused_mesh`` drain a round; each rank holds an eighth
    of every weight matrix's bytes."""
    cfg = get_config("llama3.2-3b").reduced()
    mesh = mesh_of(mesh_name)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 70, 33)]
    events = []
    hook = lambda n, p, mech: events.append(mech)
    add_launch_hook(hook)
    try:
        whole, _ = _engine_tokens(init_params(cfg, seed=0, device="cpu"),
                                  mesh, prompts, events)
        model = place_params(init_params(cfg, seed=0, device="cpu"), mesh)
        placed, drains = _engine_tokens(model, mesh, prompts, events)
    finally:
        remove_launch_hook(hook)
    assert placed.tokens == whole.tokens
    for sid in whole.tokens:
        np.testing.assert_allclose(placed.last_logits[sid],
                                   whole.last_logits[sid], atol=LOGIT_ATOL)
    assert all(d in ([], ["fused_mesh"]) for d in drains), drains
    for name, v in model.placement.values.items():
        if v.ndim == 2:
            assert isinstance(v, Sharded), name
            assert rank_bytes([v], mesh) == [v.shape.numel() * 4 // 8] * 8


def test_odd_prompt_length_keeps_rows_whole():
    """(d) ``act_seq_tp`` falls back as the reference's rule: a prompt
    whose length the ``model`` axis does not divide runs its residual
    whole over the model ranks (one row block), and the placed prefill
    equals the unplaced one within the tolerances."""
    cfg = get_config("llama3.2-3b").reduced()
    mesh = mesh_of("seq (1, 8)")
    assert attn_strategy(cfg.num_heads, mesh) == "seq"
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab_size, (1, 37)))
    whole = init_params(cfg, seed=0, device="cpu")
    model = place_params(init_params(cfg, seed=0, device="cpu"), mesh)
    offsets = []
    flash = ops.flash_attention

    def spy(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        return flash(*a, **kw)

    ops.flash_attention = spy
    try:
        lp, kp, vp = model.prefill(tokens, mesh=mesh)
    finally:
        ops.flash_attention = flash
    lw, kw_, vw = whole.prefill(tokens)
    assert set(offsets) == {0} and len(offsets) == cfg.num_layers
    np.testing.assert_allclose(lp.numpy(), lw.numpy(), atol=LOGIT_ATOL)
    np.testing.assert_allclose(kp[0].numpy(), kw_.numpy(), atol=KV_ATOL)
    np.testing.assert_allclose(vp[0].numpy(), vw.numpy(), atol=KV_ATOL)


def test_placed_prefill_refuses_another_mesh():
    """A placed model runs over its placement's mesh only."""
    cfg = get_config("llama3.2-3b").reduced()
    model = place_params(init_params(cfg, seed=0, device="cpu"),
                         mesh_of("heads (2, 4)"))
    tokens = torch.ones((2, 16), dtype=torch.long)
    for mesh in (None, mesh_of("seq (1, 8)")):
        with pytest.raises(ValueError, match="placed over a mesh"):
            model.prefill(tokens, mesh=mesh)
    with pytest.raises(ValueError, match="placed already"):
        place_params(model, mesh_of("heads (2, 4)"))


def test_placed_model_checks_and_refuses_training():
    """``check_placed`` says whether a serving call runs the placed path
    (the engine and both entry points ask it); the training loss refuses
    a placed model whatever its family."""
    cfg = get_config("llama3.2-3b").reduced()
    mesh = mesh_of("heads (2, 4)")
    model = init_params(cfg, seed=0, device="cpu")
    assert model.check_placed(None) is False
    assert model.check_placed(mesh) is False
    place_params(model, mesh)
    assert model.check_placed(mesh) is True
    tokens = torch.ones((2, 16), dtype=torch.long)
    batch = {"tokens": tokens, "labels": tokens, "mask": torch.ones_like(
        tokens, dtype=torch.float32)}
    with pytest.raises(ValueError, match="serve only"):
        model.loss_fn(batch, mesh=mesh)


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("q0,Sq,Skv", [(0, 24, 24), (16, 16, 32),
                                       (40, 24, 64), (13, 7, 20)])
def test_k3_q_offset_matches_reference_pos_q(D, q0, Sq, Skv):
    """K3's plain version with ``q_offset`` (a block of query rows) against
    the reference's model-level ``flash_attention`` with ``pos_q`` offset
    by the block's first position over every key up to its last row
    (fp32, atol 1e-4): the contract the placed ``"seq"`` attention gives
    K3."""
    rng = np.random.default_rng(D + q0)
    B, H, KVH = 2, 4, 2
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    pos_q = jnp.broadcast_to(jnp.arange(q0, q0 + Sq, dtype=jnp.int32),
                             (B, Sq))
    pos_kv = jnp.broadcast_to(jnp.arange(Skv, dtype=jnp.int32), (B, Skv))
    want = jax_model_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           pos_q, pos_kv, jnp.ones((B, Skv), bool),
                           MaskInfo(causal=True), kv_chunk=8)
    got = ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (q, k, v)), causal=True,
                              q_offset=q0).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
