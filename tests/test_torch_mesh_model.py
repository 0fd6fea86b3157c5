"""The port's model layer over a rank mesh against the JAX package's, on
forced JAX host devices (one subprocess per group of checks, marker
``mesh``):

* ``moe_ffn(mesh=)`` against the reference's ``moe_ffn`` on reduced
  deepseek-moe-16b with its published routing (64 experts, top 6), where
  choices drop: the all-to-all path over ``("model",)`` 4 and ``(2, 2)``
  data x model, the FSDP path over ``("data",)`` 4, the local fallback
  over ``(2, 4)`` with B = 1 and wherever 4 does not divide S = 62; the
  same path, ``y`` and ``aux``;
* a port ``ServingEngine`` over ``("model",)`` 4 CPU ranks against the
  reference's engine over 4 devices, one 64-token moe prompt (the
  all-to-all prefill): prefill logits and greedy tokens;
* ``prefill_state(mesh=)`` / ``decode_state(mesh=)`` of vlm, ssm, hybrid
  and encdec over ``(2, 4)`` and ``("model",)`` against the reference's
  ``prefill`` / ``decode_step`` under the same mesh, 4 greedy steps:
  logits, the slabs gathered back into pools, recurrent and cross
  states.

Tolerances as the moe and facade tests: fp32 moe outputs atol 1e-4, aux
relative 1e-5; logits atol 4e-3 (bf16 heads); states atol 1e-4, rtol
1e-4.
"""
import numpy as np
import pytest

from _meshproc import run_device_subprocess

MOE_ATOL, AUX_RTOL = 1e-4, 1e-5
LOGIT_ATOL, STATE_ATOL = 4e-3, 1e-4

#: (mesh shape, axes, B, S) of the moe cases and the path each takes
MOE_CASES = {
    "model 4, S 64": ((4,), ("model",), 2, 64, "a2a"),
    "model 4, S 62": ((4,), ("model",), 2, 62, "local"),
    "data x model 2x2, S 64": ((2, 2), ("data", "model"), 2, 64, "a2a"),
    "data x model 2x2, S 62": ((2, 2), ("data", "model"), 2, 62, "a2a"),
    "data 4, S 64": ((4,), ("data",), 4, 64, "fsdp"),
    "data 4, S 62": ((4,), ("data",), 4, 62, "fsdp"),
    "data x model 2x4, B 1, S 64": ((2, 4), ("data", "model"), 1, 64,
                                    "local"),
    "data x model 2x4, B 1, S 62": ((2, 4), ("data", "model"), 1, 62,
                                    "local"),
}

MOE_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

import repro.models.moe as jmoe
from repro.configs import get_config as jget_config
from repro.models import split_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe

torch.set_num_threads(1)
cases = json.loads(sys.argv[1])
jc = dataclasses.replace(jget_config("deepseek-moe-16b").reduced(),
                         num_experts=64, top_k=6)
tc = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                         num_experts=64, top_k=6)
tree, _ = split_params(jmoe.init_moe_ffn(jax.random.key(0), jc))
tree = jax.tree_util.tree_map(np.asarray, tree)
m = moe.MoEFFN(tc, torch.float32, "cpu")
for name in ("router", "w_gate", "w_up", "w_down"):
    getattr(m, name).data.copy_(torch.from_numpy(np.array(tree[name])))
for name in ("w_gate", "w_up", "w_down"):
    getattr(m.shared, name).data.copy_(
        torch.from_numpy(np.array(tree["shared"][name])))

seen = []
def spy(name, fn):
    def wrapped(params, x, cfg, mesh):
        if name != "local" or mesh is not None:
            seen.append(name)
        return fn(params, x, cfg, mesh)
    return wrapped
jmoe._moe_ffn_local = spy("local", jmoe._moe_ffn_local)
jmoe._moe_ffn_a2a = spy("a2a", jmoe._moe_ffn_a2a)
jmoe._moe_ffn_fsdp = spy("fsdp", jmoe._moe_ffn_fsdp)

out = {}
for name, (shape, axes, B, S, _) in cases.items():
    n = int(np.prod(shape))
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(axes))
    tm = make_test_mesh(tuple(shape), tuple(axes), devices="cpu")
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)
    del seen[:]
    yj, auxj = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, jc, jm))(
        tree, jnp.asarray(x))
    yj = np.asarray(yj)
    moe.PATH_COUNTS.clear()
    yt, auxt = moe.moe_ffn(m, torch.from_numpy(x), tc, tm)
    yl, _ = moe.moe_ffn_local(m, torch.from_numpy(x), tc)
    rows = np.abs(yl.numpy() - yj).max(-1) > 1e-4
    first = np.argwhere(rows)
    out[name] = {
        "ref_path": seen[-1], "port_path": moe.moe_path(tm, x.shape, tc),
        "counted": dict(moe.PATH_COUNTS),
        "y_err": float(np.abs(yt.numpy() - yj).max()),
        "y_scale": float(np.abs(yj).max()),
        "aux": [float(auxt), float(auxj)],
        "local_rows_differ": int(rows.sum()), "rows": int(B * S),
        "first_local_row": [int(v) for v in first[0]] if len(first) else None,
        "local_err": float(np.abs(yl.numpy() - yj).max())}
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def moe_results(tmp_path_factory):
    import json
    return run_device_subprocess(
        MOE_CHILD, args=[json.dumps(MOE_CASES)],
        tmp_path=tmp_path_factory.mktemp("moe"), timeout=600)


@pytest.mark.mesh
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_mesh_matches_reference(moe_results, case):
    """``moe_ffn(mesh=)`` takes the reference's path and computes its
    ``y`` within ``MOE_ATOL`` and ``aux`` within ``AUX_RTOL``.  Where the
    all-to-all path runs, the local path differs from the reference in
    many rows (the capacity comes from each rank's tokens, and choices
    drop), so this is the check the parent's port failed."""
    r = moe_results[case]
    want = MOE_CASES[case][-1]
    assert r["ref_path"] == r["port_path"] == want, r
    assert r["counted"] == {want: 1}, r
    assert r["y_err"] <= MOE_ATOL and r["y_scale"] > 0.1, r
    np.testing.assert_allclose(r["aux"][0], r["aux"][1], rtol=AUX_RTOL)
    if want == "a2a":
        assert r["local_rows_differ"] > 0, r
    else:
        assert r["local_rows_differ"] == 0, r


ENGINE_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json
import jax, numpy as np, torch
from jax.sharding import Mesh

from repro.configs import get_config as jget_config
from repro.launch.serve import ServingEngine as JServing
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import moe
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)
jc = dataclasses.replace(jget_config("deepseek-moe-16b").reduced(),
                         num_experts=64, top_k=6)
tc = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                         num_experts=64, top_k=6)
params, _ = split_params(build_model(jc).init_params(jax.random.key(0)))
tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tc,
                         device="cpu")
jm = Mesh(np.asarray(jax.devices()[:4]), ("model",))
tm = make_test_mesh((4,), ("model",), devices="cpu")
kw = dict(max_seqs=4, max_blocks_per_seq=4, num_slabs=4)
jeng = JServing(jc, params, mesh=jm, **kw)
teng = ServingEngine(tc, tmodel, mesh=tm, **kw)
one = ServingEngine(tc, tmodel, device="cpu", **kw)
prompt = np.random.default_rng(5).integers(
    2, tc.vocab_size, size=64).astype(np.int32)
moe.PATH_COUNTS.clear()
sj, st, so = (e.add_request(prompt.copy()) for e in (jeng, teng, one))
paths = dict(moe.PATH_COUNTS)
first = [np.asarray(e.last_logits[s]).tolist()
         for e, s in ((jeng, sj), (teng, st), (one, so))]
for _ in range(3):
    for e in (jeng, teng, one):
        e.decode_round()
print("RESULTS:" + json.dumps({
    "logits": first, "paths": paths,
    "tokens": [jeng.tokens[sj], teng.tokens[st], one.tokens[so]]}))
"""


@pytest.mark.mesh
def test_moe_engine_over_model_mesh_matches_reference(tmp_path):
    """One 64-token prompt admitted by the port's ``ServingEngine`` over
    ``("model",)`` 4 CPU ranks and by the reference's over 4 devices
    (reduced deepseek-moe-16b with 64 experts top 6): the prefill's FFN
    takes the all-to-all path in every layer (the two engines' moe
    prefills ran 4 + 4 layers: the mesh engine's a2a, the single-device
    engine's local), the prefill logits agree within ``LOGIT_ATOL`` and
    the greedy tokens of 3 rounds are equal.  The port's single-device
    engine, whose capacity is the whole prompt's, differs from both."""
    res = run_device_subprocess(ENGINE_CHILD, tmp_path=tmp_path, timeout=600)
    ref, got, one = (np.asarray(l) for l in res["logits"])
    assert res["paths"] == {"a2a": 4, "local": 4}, res["paths"]
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)
    top = np.sort(ref)[-2:]
    assert top[1] - top[0] > 2 * LOGIT_ATOL
    assert res["tokens"][1] == res["tokens"][0]
    assert np.abs(one - ref).max() > 10 * LOGIT_ATOL


#: the facade cases: family -> (arch, text tokens); every prompt is 48
#: positions (vlm: 16 patches + 32), so 4 sequences hold 8 blocks of 64
FACADE_ARCHS = {"vlm": ("paligemma-3b", 32), "ssm": ("mamba2-780m", 48),
                "hybrid": ("zamba2-2.7b", 48),
                "encdec": ("seamless-m4t-medium", 48)}
FACADE_MESHES = {"data x model": ((2, 4), ("data", "model")),
                 "model": ((4,), ("model",))}

FACADE_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

from repro.configs import get_config as jget_config
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)
archs, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
B, STEPS = 4, 4
STATE = ("k_pools", "v_pools", "conv_state", "ssm_state", "cross_k",
         "cross_v")
LAYOUT = ("seq_lens", "block_table", "share_mask", "base")
out = {}
for fam, (arch, S) in archs.items():
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel = build_model(jc)
    params, _ = split_params(jmodel.init_params(jax.random.key(0)))
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tc,
                             device="cpu")
    rng = np.random.default_rng(len(fam))
    prompts = rng.integers(2, tc.vocab_size, (B, S)).astype(np.int32)
    batch, extra = {"tokens": jnp.asarray(prompts)}, {}
    if fam == "vlm":
        a = (rng.standard_normal((B, tc.vision_tokens, tc.d_model))
             * 0.02).astype(np.float32)
        batch["patch_embeds"], extra["patch_embeds"] = jnp.asarray(a), \
            torch.from_numpy(a)
    if fam == "encdec":
        a = (rng.standard_normal((B, S // 4, tc.d_model))
             * 0.02).astype(np.float32)
        batch["src_embeds"], extra["src_embeds"] = jnp.asarray(a), \
            torch.from_numpy(a)
    for mname, (shape, axes) in meshes.items():
        n = int(np.prod(shape))
        jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(axes))
        tm = make_test_mesh(tuple(shape), tuple(axes), devices="cpu")
        rec = {"logit_err": [], "tokens_equal": True, "state_err": {},
               "layout_equal": True}

        def compare(sj, st):
            for key in LAYOUT:
                if key in sj:
                    rec["layout_equal"] &= bool(np.array_equal(
                        st[key].numpy(), np.asarray(sj[key])))
            for key in STATE:
                if key not in sj:
                    continue
                t = st[key]
                if isinstance(t, list):
                    rec["slabs"] = [tuple(s.shape) for s in t]
                    t = torch.cat(t, dim=1)
                w = np.asarray(sj[key]).astype(np.float32)
                if tuple(t.shape) != w.shape:
                    rec["state_err"][key] = float("inf")
                    continue
                err = np.abs(t.float().numpy() - w) - 1e-4 * np.abs(w)
                rec["state_err"][key] = max(rec["state_err"].get(key, 0.0),
                                            float(err.max()))

        prefill = jax.jit(lambda p, b: jmodel.prefill(p, b, jm))
        decode = jax.jit(lambda p, s, t: jmodel.decode_step(p, s, t, jm))
        with jm:
            lj, sj = prefill(params, batch)
        lt, st = tmodel.prefill_state(torch.from_numpy(prompts).long(),
                                      mesh=tm, **extra)
        rec["logit_err"].append(float(np.abs(lt.numpy() - np.asarray(lj))
                                      .max()))
        compare(sj, st)
        for step in range(STEPS):
            tok = np.asarray(jnp.argmax(lj, -1), np.int32)
            rec["tokens_equal"] &= bool(np.array_equal(
                lt.argmax(-1).numpy(), tok))
            with jm:
                lj, sj = decode(params, sj, jnp.asarray(tok))
            lt, st = tmodel.decode_state(st, torch.from_numpy(tok).long(),
                                         mesh=tm)
            rec["logit_err"].append(float(np.abs(lt.numpy() -
                                                 np.asarray(lj)).max()))
        compare(sj, st)
        rec["mask_cols"] = int(st["share_mask"].shape[1]) \
            if "share_mask" in st else None
        out[f"{fam} / {mname}"] = rec
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def facade_results(tmp_path_factory):
    import json
    return run_device_subprocess(
        FACADE_CHILD, args=[json.dumps(FACADE_ARCHS),
                            json.dumps(FACADE_MESHES)],
        tmp_path=tmp_path_factory.mktemp("facade"), timeout=900)


@pytest.mark.mesh
@pytest.mark.parametrize("mesh_name", list(FACADE_MESHES))
@pytest.mark.parametrize("family", list(FACADE_ARCHS))
def test_facade_over_mesh_matches_reference(facade_results, family,
                                            mesh_name):
    """``prefill_state(mesh=)`` and 4 greedy ``decode_state(mesh=)``
    steps against the reference's ``prefill`` / ``decode_step`` under the
    same mesh: the layout (block table, share mask with 2 local columns
    over ``(2, 4)``, 4 global over ``("model",)``, base, lengths) equal,
    logits within ``LOGIT_ATOL`` at every call, the same greedy tokens,
    and the pools (the per-rank slabs concatenated in shard order: 8 or 4
    slabs of the 8 blocks), recurrent and cross states within
    ``STATE_ATOL`` + 1e-4 relative after the prefill and after the last
    step."""
    r = facade_results[f"{family} / {mesh_name}"]
    assert r["layout_equal"] and r["tokens_equal"], r
    assert max(r["logit_err"]) <= LOGIT_ATOL, r
    assert r["state_err"] and max(r["state_err"].values()) <= STATE_ATOL, r
    if family != "ssm":
        n = 8 if mesh_name == "data x model" else 4
        assert len(r["slabs"]) == n and all(s[1] == 8 // n
                                            for s in r["slabs"]), r
        assert r["mask_cols"] == (2 if mesh_name == "data x model" else 4)
