"""The facades' serving weights placed over a rank mesh
(``weights.place_params``) against the JAX package, on the CPU: the vlm,
ssm, hybrid and encdec families through ``prefill_state(mesh=)`` /
``decode_state(mesh=)``, each rank computing with the blocks it holds,
and the serve state placed by ``LanguageModel.state_logical_axes``.

ONE subprocess with 8 forced JAX host devices (marker ``mesh``) holds,
for the reduced paligemma-3b, mamba2-780m, zamba2-2.7b and
seamless-m4t-medium over (2, 4) and (1, 8) ranks of ``("data",
"model")``:

* (a) every placed weight's block on every rank equals, bitwise, the
  reference's ``addressable_shards`` of ``tree_shardings(mesh, params,
  axes)``; the port's ``state_logical_axes`` equal the reference's leaf
  for leaf, and after the prefill every placed state leaf's block (the
  slabs, the recurrent and cross states) equals the reference's shard
  under them within ``STATE_ATOL``;
* (b) ``prefill_state(mesh=)`` and 3 greedy ``decode_state(mesh=)`` on
  the placed model against the reference's ``jax.jit(model.prefill /
  decode_step, in_shardings=(p_sh, ...))``: logits within
  ``LOGIT_ATOL``, pools, recurrent and cross states within
  ``STATE_ATOL``, the same greedy tokens.  The Mamba2 layers' ``w_in``
  blocks straddle ``z | xBC | dt`` (552 columns: 138 a rank over 4, 69
  over 8); the vlm over (1, 8) runs ``"seq"`` attention in blocks of 6
  of its 48 rows (16 patches + 32), the first two ending inside the
  prefix; the encdec's cross state splits by batch over (2, 4).

In this process: (c) the gate norm over all ``d_inner`` channels, where a
per-block RMS fails; (d) ``ServingEngine(mesh=)`` over placed reduced
zamba2 and seamless admits like the unplaced mesh engine.
"""
import json

import numpy as np
import pytest
import torch

from _meshproc import run_device_subprocess

from repro_torch.configs import get_config
from repro_torch.kernels.fused_dispatch import (add_launch_hook,
                                                remove_launch_hook)
from repro_torch.launch.mesh import (Sharded, gather, make_test_mesh,
                                     map_blocks)
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.common import rms_norm
from repro_torch.models.lm import PLACED_FAMILIES, PORTED_FAMILIES
from repro_torch.models.mamba2 import gate_norm_placed, ssm_layouts
from repro_torch.weights import init_params, place_params

#: bf16 heads (as tests/test_torch_mesh_model.py); fp32 states of another
#: summation order (atol, plus 1e-4 relative)
LOGIT_ATOL, STATE_ATOL = 4e-3, 1e-4

MESHES = {"(2, 4)": ((2, 4), ("data", "model")),
          "(1, 8)": ((1, 8), ("data", "model"))}
#: family -> (arch, text tokens): every sequence is 48 positions (the
#: vlm's 16 patches + 32), so 4 sequences hold 8 blocks of 64
ARCHS = {"vlm": ("paligemma-3b", 32), "ssm": ("mamba2-780m", 48),
         "hybrid": ("zamba2-2.7b", 48),
         "encdec": ("seamless-m4t-medium", 48)}

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
from repro_torch.launch.mesh import Sharded, gather, make_test_mesh
from repro_torch.launch.mesh import pool_shard_ranks
from repro_torch.weights import from_jax_params, jax_path, place_params

torch.set_num_threads(1)
archs, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
B, STEPS = 4, 3
STATE = ("k_pools", "v_pools", "conv_state", "ssm_state", "cross_k",
         "cross_v")

calls = []
flash = ops.flash_attention
def spy(q, k, v, **kw):
    calls.append([kw.get("q_offset", 0), kw.get("prefix_len", 0),
                  int(q.shape[2]), int(k.shape[2]),
                  bool(kw.get("causal", True))])
    return flash(q, k, v, **kw)
ops.flash_attention = spy

def state_err(t, w):
    w = np.asarray(w).astype(np.float32)
    t = t.float().numpy()
    if t.shape != w.shape:
        return float("inf")
    return float((np.abs(t - w) - 1e-4 * np.abs(w)).max())

def whole(v):
    if isinstance(v, list):
        return torch.cat(v, dim=1)
    return gather(v) if isinstance(v, Sharded) else v

out = {}
for fam, (arch, S) in archs.items():
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel = build_model(jc)
    params, axes = split_params(jmodel.init_params(jax.random.key(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(len(fam))
    prompts = rng.integers(2, tc.vocab_size, (B, S)).astype(np.int32)
    batch, extra = {"tokens": prompts}, {}
    n_extra = {"vlm": tc.vision_tokens, "encdec": S // 4}.get(fam)
    if n_extra:
        key = "patch_embeds" if fam == "vlm" else "src_embeds"
        a = (rng.standard_normal((B, n_extra, tc.d_model))
             * 0.02).astype(np.float32)
        batch[key], extra[key] = a, torch.from_numpy(a)
    for mname, (shape, mesh_axes) in meshes.items():
        n = int(np.prod(shape))
        jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                  tuple(mesh_axes))
        tm = make_test_mesh(tuple(shape), tuple(mesh_axes), devices="cpu")
        rank_of = {d.id: r for r, d in enumerate(jm.devices.flat)}
        p_sh = jtree_shardings(jm, params, axes)
        pj = jax.device_put(params, p_sh)
        model = place_params(from_jax_params(tree, tc, device="cpu"), tm)
        rec = {"checked": 0, "differ": [], "logit_err": [],
               "tokens_equal": True, "state_err": {}, "block_err": {},
               "blocks_checked": 0}
        # (a) every rank's weight block against the reference's shard
        for name, v in model.placement.values.items():
            path, idx = jax_path(name)
            leaf = pj
            for key in path:
                leaf = leaf[key]
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
        w_in = model.placement.values.get("layers.0.w_in")
        if w_in is not None:
            rec["w_in_block"] = list(next(iter(w_in.blocks.values())).shape)
        # (b) the prefill against the jitted sharded reference
        b_sh = {k: jsharding_for(jm, v.shape, ("batch",) + (None,) *
                                 (v.ndim - 1)) for k, v in batch.items()}
        prefill = jax.jit(lambda p, b: jmodel.prefill(p, b, jm),
                          in_shardings=(p_sh, b_sh))
        with jm:
            lj, sj = prefill(pj, jax.device_put(
                {k: jnp.asarray(v) for k, v in batch.items()}, b_sh))
        del calls[:]
        lt, st = model.prefill_state(torch.from_numpy(prompts).long(),
                                     mesh=tm, **extra)
        rec["k3_calls"] = sorted(map(list, set(map(tuple, calls))))
        rec["logit_err"].append(float(np.abs(lt.numpy() - np.asarray(lj))
                                      .max()))
        st_ax = jmodel.state_logical_axes(sj)
        rec["axes_equal"] = {k: list(map(str, model.state_logical_axes(st)
                                         [k])) == list(map(str, st_ax[k]))
                             for k in st_ax}
        st_sh = {k: jsharding_for(jm, x.shape, st_ax[k])
                 for k, x in sj.items()}
        sjp = jax.device_put(sj, st_sh)
        # (a) the placed state's blocks against the reference's shards
        ranks = pool_shard_ranks(tm)
        for key in STATE:
            if key not in st:
                continue
            v = st[key]
            rec["placed_" + key] = isinstance(v, (Sharded, list))
            for shard in sjp[key].addressable_shards:
                r = rank_of[shard.device.id]
                got = v[ranks.index(r)] if isinstance(v, list) else \
                    v.blocks[v.sharding.block_of(r)]
                rec["blocks_checked"] += 1
                rec["block_err"][key] = max(rec["block_err"].get(key, 0.0),
                                            state_err(got, shard.data))
            rec["state_err"][key] = state_err(whole(v), sj[key])
        if "cross_k" in st:
            rec["cross_blocks"] = [list(t.shape) for t in
                                   st["cross_k"].blocks.values()]
        tok_sh = jsharding_for(jm, (B,), ("batch",))
        decode = jax.jit(lambda p, s, t: jmodel.decode_step(p, s, t, jm),
                         in_shardings=(p_sh, st_sh, tok_sh))
        for step in range(STEPS):
            tok = np.asarray(jnp.argmax(lj, -1), np.int32)
            rec["tokens_equal"] &= bool(np.array_equal(
                lt.argmax(-1).numpy(), tok))
            with jm:
                lj, sj = decode(pj, jax.device_put(sj, st_sh),
                                jax.device_put(jnp.asarray(tok), tok_sh))
            lt, st = model.decode_state(st, torch.from_numpy(tok).long(),
                                        mesh=tm)
            rec["logit_err"].append(float(np.abs(lt.numpy() -
                                                 np.asarray(lj)).max()))
        rec["tokens_equal"] &= bool(np.array_equal(
            lt.argmax(-1).numpy(), np.asarray(jnp.argmax(lj, -1))))
        for key in STATE:
            if key in st:
                rec["state_err"][key] = max(rec["state_err"][key],
                                            state_err(whole(st[key]),
                                                      sj[key]))
        out[f"{fam} / {mname}"] = rec
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_device_subprocess(
        CHILD, args=[json.dumps(ARCHS), json.dumps(MESHES)],
        tmp_path=tmp_path_factory.mktemp("facades"), timeout=900)


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


CASES = [(f, m) for f in ARCHS for m in MESHES]


@pytest.mark.mesh
@pytest.mark.parametrize("family,mesh_name", CASES)
def test_placed_facade_blocks_equal_reference_shards(results, family,
                                                     mesh_name):
    """(a) Every rank's block of every placed weight equals, bitwise, the
    reference's shard on that rank's device (8 shards a weight); the
    state's logical axes are the reference's leaf for leaf; the slabs and
    the placed recurrent and cross states come as blocks, each within
    ``STATE_ATOL`` of the reference's shard of the prefill's state on its
    rank."""
    r = results[f"{family} / {mesh_name}"]
    assert r["differ"] == [] and r["checked"] % 8 == 0 and r["checked"], r
    assert r["axes_equal"] and all(r["axes_equal"].values()), r
    placed = [k for k in r if k.startswith("placed_")]
    assert placed and all(r[k] for k in placed), r
    assert r["blocks_checked"] == 8 * len(placed), r
    assert max(r["block_err"].values()) <= STATE_ATOL, r


@pytest.mark.mesh
@pytest.mark.parametrize("family,mesh_name", CASES)
def test_placed_facade_matches_reference(results, family, mesh_name):
    """(b) The placed ``prefill_state`` and three ``decode_state``s against
    the reference's jitted calls on the placed weights and state: logits
    within ``LOGIT_ATOL`` at every call, pools and recurrent / cross
    states within ``STATE_ATOL`` after the prefill and after the steps,
    equal greedy tokens.  A Mamba2 layer's ``w_in`` block holds 552 /
    ``model`` columns, across the z | xBC | dt boundaries (256, 544); the
    vlm over (1, 8) runs K3 on 8 row blocks of 6 at ``q_offset`` 0-42
    with the 16-patch prefix, the first two reading the K/V rows up to
    16; the encdec's cross state lies in 2 batch blocks over (2, 4)."""
    r = results[f"{family} / {mesh_name}"]
    assert r["tokens_equal"], r
    assert max(r["logit_err"]) <= LOGIT_ATOL, r
    assert r["state_err"] and max(r["state_err"].values()) <= STATE_ATOL, r
    M = MESHES[mesh_name][0][1]
    if family in ("ssm", "hybrid"):
        assert r["w_in_block"] == [128 // MESHES[mesh_name][0][0], 552 // M]
        assert 256 % (552 // M) and 544 % (552 // M)
    if family == "vlm" and mesh_name == "(1, 8)":
        # (q_offset, prefix_len, Sq, Skv, causal) of each K3 call
        assert r["k3_calls"] == sorted(
            [s0, 16, 6, max(s0 + 6, 16), True] for s0 in range(0, 48, 6))
    if family == "encdec":
        groups = MESHES[mesh_name][0][0]
        assert r["cross_blocks"] == [[4, 4 // groups, 12, 4, 32]] * groups


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_gate_norm_combines_blocks(mesh_name):
    """(c) ``gate_norm_placed`` normalises each position over all
    ``d_inner`` channels from the blocks' fp32 sums of squares: on a gated
    activation whose head blocks lie 10x apart in scale it equals the
    whole ``rms_norm`` (1e-5 relative), where normalising each block by
    its own RMS, as ``rms_norm_placed`` does, is off by more than 10%."""
    cfg = get_config("mamba2-780m").reduced()
    mesh = mesh_of(mesh_name)
    model = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    layer = model.layers[0]
    layer.gate_norm.data.copy_(0.3 * torch.randn(layer.gate_norm.shape,
                                                 generator=gen))
    gain = layer.gate_norm.detach().clone()
    place_params(model, mesh)
    B, S, di = 2, 8, cfg.ssm_d_inner
    hsh, _ = ssm_layouts(mesh, B, S, cfg)
    nh = hsh.counts(3)[2]
    scale = torch.repeat_interleave(10.0 ** torch.arange(nh), di // nh)
    x = torch.randn((B, S, di), generator=gen) * scale
    gated = map_blocks(hsh, x.shape, lambda b, sl, r: x[sl].clone())
    ssq = map_blocks(hsh, (B, S, nh), lambda b, sl, r: gated.blocks[b]
                     .square().sum(-1, keepdim=True))
    got = gather(gate_norm_placed(layer, gated, ssq, cfg, torch.float32))
    want = rms_norm(x, gain, cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    per_block = torch.cat([rms_norm(c, g, cfg.norm_eps) for c, g in zip(
        x.chunk(nh, -1), gain.chunk(nh))], -1)
    assert float((per_block - want).abs().max()) > \
        0.1 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium"])
def test_placed_engine_admits_like_unplaced_mesh_engine(arch):
    """(d) ``ServingEngine(mesh=)`` over the placed reduced model against
    the unplaced model's over the same (2, 4) mesh: three prompts (one of
    an odd length) admitted, the admission rounds drained: the same
    sequence ids, logits within ``LOGIT_ATOL``, the promoted blocks and
    the per-sequence state (the hybrid's conv / ssm, the encdec's cross
    K/V: whole tensors on the engine's device) within ``STATE_ATOL``, at
    most one ``fused_mesh`` drain a round."""
    cfg = get_config(arch).reduced()
    mesh = mesh_of("(2, 4)")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 70, 33)]
    events = []
    hook = lambda n, p, mech: events.append(mech)
    engines, drains = [], []
    add_launch_hook(hook)
    try:
        for placed in (False, True):
            model = init_params(cfg, seed=0, device="cpu")
            if placed:
                place_params(model, mesh)
            eng = ServingEngine(cfg, model, mesh=mesh, max_seqs=4,
                                max_blocks_per_seq=4, num_slabs=4)
            sids = [eng.add_request(p) for p in prompts]
            e0 = len(events)
            eng.stream.flush()
            eng._post_flush()
            drains.append(events[e0:])
            engines.append((eng, sids))
    finally:
        remove_launch_hook(hook)
    (whole, ws), (placed_eng, ps) = engines
    assert ws == ps
    assert all(d in ([], ["fused_mesh"]) for d in drains), drains
    for s in ws:
        np.testing.assert_allclose(placed_eng.last_logits[s],
                                   whole.last_logits[s], atol=LOGIT_ATOL)
        assert set(placed_eng._extras[s]) == set(whole._extras[s])
        for k, t in whole._extras[s].items():
            got = placed_eng._extras[s][k]
            assert isinstance(got, torch.Tensor) and got.shape == t.shape
            assert got.device == placed_eng.device
            np.testing.assert_allclose(got.numpy(), t.numpy(),
                                       atol=STATE_ATOL, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(placed_eng.engine.pools[name].numpy(),
                                   whole.engine.pools[name].numpy(),
                                   atol=STATE_ATOL, rtol=1e-4)


def test_every_family_serves_placed():
    """``PLACED_FAMILIES`` holds every serving family, and a placed model's
    serve state holds its recurrent and cross leaves as blocks (none of
    them whole on the first rank) while the unplaced model's over the same
    mesh stay whole."""
    assert set(PLACED_FAMILIES) == set(PORTED_FAMILIES) == {
        "dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
    mesh = mesh_of("(2, 4)")
    for arch in ("zamba2-2.7b", "seamless-m4t-medium"):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, seed=0, device="cpu")
        before = model.make_serve_state(4, 128, mesh=mesh)
        place_params(model, mesh)
        after = model.make_serve_state(4, 128, mesh=mesh)
        keys = [k for k in ("conv_state", "ssm_state", "cross_k", "cross_v")
                if k in after]
        assert keys
        for k in keys:
            assert isinstance(before[k], torch.Tensor)
            assert isinstance(after[k], Sharded) and len(after[k].blocks) > 1
            assert after[k].shape == before[k].shape
