"""The port's training over a rank mesh against the JAX package's, on the
CPU (the moe cases, the elastic restore and the DP all-reduce are in
``tests/test_torch_mesh_elastic.py``; the files run on separate workers):

* one ``make_train_step`` step over a mesh of CPU ranks, the state placed
  by ``build_train_step``'s ``shard_state``, against the reference's
  jitted step under the same mesh with ``build_jit_train_step``'s
  shardings applied (forced JAX host devices in a subprocess, marker
  ``mesh``): llama3.2-3b reduced over (2, 2, 2) and (2, 4) under both
  ``TrainConfig.sharding`` values (and under ``"fsdp"`` with two
  microbatches, each laid out again by the batch spec), paligemma-3b,
  seamless-m4t-medium, mamba2-780m and zamba2-2.7b over (2, 2), each block
  of the loss computed on the rank that holds it.  The tolerances are
  ``tests/test_torch_train_loop.py``'s: loss rtol 1e-5, ``grad_norm``
  rtol 1e-3, each updated weight within 2e-6 + 1e-2 x lr where its grad
  is firm (else 2 lr), each moment within 3% of the leaf's largest; every parameter's resolved spec equals the
  reference's ``NamedSharding`` spec (its stacked layer axis dropped);
* ``attention_train_placed`` over each strategy and layout (q, k and v
  placed by ``placed_qkv_shardings``: heads over ``model`` with K/V heads
  sharded, replicated and straddling a group; query positions over
  ``model``, and whole where 4 does not divide S; batch rows under
  ``FSDP_RULES``): outputs and grads against ``attention_train`` whole
  (each block is the same online softmax on fewer rows or heads: atol
  1e-6 on outputs, 1e-5 on grads), and the blocks it ran;
* ``place`` / ``gather`` round trips, bitwise, and each block's owner;
* the parameter-axes table against ``split_params``'s axes tree for every
  family.
"""
import json

import numpy as np
import pytest
import torch

import jax

from _meshproc import run_device_subprocess
from test_torch_contract import one_thread  # noqa: F401

from repro.configs import get_config as jget_config
from repro.core.poolspec import PoolSpec as JPoolSpec
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.core.poolspec import PoolSpec
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tatt
from repro_torch.sharding import rules
from repro_torch.weights import init_params, jax_path, params_axes

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-3
LOSS_RTOL, GNORM_RTOL, MOMENT_SHARE = 1e-5, 1e-3, 3e-2

#: name -> (arch, mesh shape, axes, sharding, B, S, config overrides[,
#: TrainConfig overrides])
STEP_CASES = {
    "llama fsdp 2x4": ("llama3.2-3b", (2, 4), ("data", "model"), "fsdp",
                       4, 64, {}),
    "llama tp 2x4": ("llama3.2-3b", (2, 4), ("data", "model"), "tp",
                     4, 64, {}),
    "llama fsdp 2x2x2": ("llama3.2-3b", (2, 2, 2), ("pod", "data", "model"),
                         "fsdp", 4, 64, {}),
    "llama tp 2x2x2": ("llama3.2-3b", (2, 2, 2), ("pod", "data", "model"),
                       "tp", 4, 64, {}),
    "vlm fsdp 2x2": ("paligemma-3b", (2, 2), ("data", "model"), "fsdp",
                     4, 48, {}),
    "encdec tp 2x2": ("seamless-m4t-medium", (2, 2), ("data", "model"),
                      "tp", 4, 64, {}),
    "ssm fsdp 2x2": ("mamba2-780m", (2, 2), ("data", "model"), "fsdp",
                     4, 64, {}),
    "hybrid tp 2x2": ("zamba2-2.7b", (2, 2), ("data", "model"), "tp",
                      4, 64, {}),
    "llama fsdp 2x4, 2 microbatches": ("llama3.2-3b", (2, 4),
                                       ("data", "model"), "fsdp", 8, 64, {},
                                       {"microbatches": 2}),
}

STEP_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

import repro.models.moe as jmoe
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import batch_logical_axes as jbatch_axes
from repro.data import make_batch as jmake_batch
from repro.launch import train as jtrain
from repro.models import build_model, split_params
from repro.optim import init_state as jinit_state
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_logical_axes, make_batch, to_device
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import gather, make_test_mesh
from repro_torch.models import moe
from repro_torch.weights import from_jax_params, jax_path, params_axes

torch.set_num_threads(1)
LR = float(sys.argv[2])
cases = json.loads(sys.argv[1])

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


def at(tree, name):
    path, idx = jax_path(name)
    for k in path:
        tree = tree[k]
    return tree, idx


def leaf(tree, name):
    t, idx = at(tree, name)
    return np.asarray(t if idx is None else np.asarray(t)[idx])


def entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


out = {}
for name, (arch, shape, axes, sharding, B, S, over, *tover) in cases.items():
    jc = dataclasses.replace(jget_config(arch).reduced(), **over)
    tc = dataclasses.replace(get_config(arch).reduced(), **over)
    jmodel = build_model(jc)
    params, paxes = split_params(jmodel.init_params(jax.random.key(0)))
    kw = dict(total_steps=8, warmup_steps=1, learning_rate=LR,
              sharding=sharding, **(tover[0] if tover else {}))
    # a step over microbatches reports no aux, the reference's neither
    aux_of = (lambda m: 0.0 if "aux" not in m else float("nan")) \
        if kw.get("microbatches", 1) > 1 else (lambda m: float(m["aux"]))
    n = int(np.prod(shape))
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(axes))
    step_fn, shard_state, bshard = jtrain.build_jit_train_step(
        jmodel, JTrainConfig(**kw), jm, paxes, jbatch_axes(jc))
    st_sh = shard_state(params)
    jb = {k: jnp.asarray(v) for k, v in jmake_batch(jc, B, S, 0).items()}
    b_sh = bshard(jb)
    jstate = jax.device_put(jtrain.TrainState(params, jinit_state(params)),
                            st_sh)
    del seen[:]
    jstate, jmet = jax.jit(step_fn, in_shardings=(st_sh, b_sh))(
        jstate, jax.device_put(jb, b_sh))

    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, tc, "cpu", param_dtype=torch.float32)
    tm = make_test_mesh(tuple(shape), tuple(axes), devices="cpu")
    step, tshard, _ = ttrain.build_train_step(
        model, TrainConfig(**kw), tm, params_axes(model),
        batch_logical_axes(tc))
    sh = tshard(dict(model.named_parameters()))
    spec_diff = []
    for pname, s in sh.params.items():
        jspec, idx = at(st_sh.params, pname)
        jspec = tuple(jspec.spec)[1:] if idx is not None else tuple(jspec.spec)
        if entries(s.spec) != entries(jspec):
            spec_diff.append([pname, entries(s.spec), entries(jspec)])
    state = ttrain.train_state(model, sh)
    moe.PATH_COUNTS.clear()
    moe.RECOMPUTE_COUNTS.clear()
    state, tmet = step(state, to_device(make_batch(tc, B, S, 0), "cpu"))
    paths, recomputed = dict(moe.PATH_COUNTS), dict(moe.RECOMPUTE_COUNTS)
    local = from_jax_params(tree, tc, "cpu", param_dtype=torch.float32)
    _, lmet = ttrain.make_train_step(local, TrainConfig(**kw))(
        ttrain.train_state(local), to_device(make_batch(tc, B, S, 0), "cpu"))

    jp = jax.tree_util.tree_map(np.asarray, jstate.params)
    jmom = jax.tree_util.tree_map(np.asarray, jstate.opt.m)
    jv = jax.tree_util.tree_map(np.asarray, jstate.opt.v)
    firm_worst, any_worst, mom_worst = 0.0, 0.0, 0.0
    for pname, p in state.params.items():
        m_ref = leaf(jmom, pname)
        firm = np.abs(m_ref) > 3e-2 * np.abs(m_ref).max()
        diff = np.abs(gather(p).detach().numpy() - leaf(jp, pname))
        firm_worst = max(firm_worst, float(diff[firm].max(initial=0)))
        any_worst = max(any_worst, float(diff.max()))
        for mine, theirs in ((state.opt.m, jmom), (state.opt.v, jv)):
            want = leaf(theirs, pname)
            got = gather(mine[pname]).numpy()
            mom_worst = max(mom_worst, float(
                np.abs(got - want).max() / (np.abs(want).max() + 1e-12)))
    out[name] = {
        "loss": [float(tmet["loss"]), float(jmet["loss"])],
        "grad_norm": [float(tmet["grad_norm"]), float(jmet["grad_norm"])],
        "lr": [float(tmet["lr"]), float(jmet["lr"])],
        "aux": [aux_of(tmet), aux_of(jmet)],
        "local": [float(lmet["loss"]), aux_of(lmet)],
        "step": [int(state.opt.step), int(jstate.opt.step)],
        "firm_worst": firm_worst, "any_worst": any_worst,
        "moment_worst": mom_worst, "spec_diff": spec_diff,
        "ref_paths": sorted(set(seen)), "paths": paths,
        "recomputed": recomputed}
print("RESULTS:" + json.dumps(out))
"""


def run_steps(cases, tmp_path):
    """The step child over ``cases`` (one subprocess, 8 forced JAX host
    devices); results by case name."""
    return run_device_subprocess(STEP_CHILD,
                                 args=[json.dumps(cases), str(LR)],
                                 tmp_path=tmp_path, timeout=900)


def check_step(r):
    """The step's metrics, updated weights, moments and shardings against
    the reference's (the tolerances of the module docstring)."""
    assert r["step"] == [1, 1], r
    assert r["spec_diff"] == [], r["spec_diff"]
    np.testing.assert_allclose(*r["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(*r["grad_norm"], rtol=GNORM_RTOL)
    np.testing.assert_allclose(*r["lr"], rtol=1e-6)
    assert r["firm_worst"] <= 2e-6 + 1e-2 * LR, r
    assert r["any_worst"] <= 2e-6 + 2 * LR, r
    assert r["moment_worst"] <= MOMENT_SHARE, r


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_steps(STEP_CASES, tmp_path_factory.mktemp("steps"))


@pytest.mark.mesh
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_train_step_matches_reference(step_results, case):
    """One step over the mesh, the state placed by ``shard_state``,
    against the reference's jitted step under the same mesh and
    shardings; these configs have no moe layer, so the loss is also one
    device's (GSPMD computes the same function over any mesh)."""
    r = step_results[case]
    check_step(r)
    assert r["aux"] == [0.0, 0.0]
    np.testing.assert_allclose(r["local"][0], r["loss"][1], rtol=LOSS_RTOL)
    assert r["paths"] == r["recomputed"] == {} and r["ref_paths"] == []


# ---------------------------------------------------------------------------
# eight steps in bf16: the placed step against one device, as the reference's
# ---------------------------------------------------------------------------

#: llama3.2-3b reduced with bf16 activations (the published configs'),
#: over (2, 4), B x S, steps at the default learning rate and schedule
DRIFT_B, DRIFT_S, DRIFT_STEPS = 2, 64, 8
#: a distance over the steps may be this many times the reference's
DRIFT_FACTOR = 3.0

DRIFT_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import batch_logical_axes as jbatch_axes
from repro.data import make_batch as jmake_batch
from repro.launch import train as jtrain
from repro.models import build_model, split_params
from repro.optim import init_state as jinit_state
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_logical_axes, make_batch, to_device
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.weights import from_jax_params, params_axes

torch.set_num_threads(1)
B, S, steps = (int(a) for a in sys.argv[1:4])
shape, axes = (2, 4), ("data", "model")
over = {"dtype": "bfloat16"}
jc = dataclasses.replace(jget_config("llama3.2-3b").reduced(), **over)
tc = dataclasses.replace(get_config("llama3.2-3b").reduced(), **over)
jmodel = build_model(jc)
params, paxes = split_params(jmodel.init_params(jax.random.key(0)))
tree = jax.tree_util.tree_map(np.asarray, params)
jbs = [{k: jnp.asarray(v) for k, v in jmake_batch(jc, B, S, i).items()}
       for i in range(steps)]
tbs = [to_device(make_batch(tc, B, S, i), "cpu") for i in range(steps)]
jm = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)


def trace(step, state, batches, put=lambda b: b):
    out = []
    for b in batches:
        state, m = step(state, put(b))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


out = {}
for sharding in ("fsdp", "tp"):
    kw = dict(total_steps=steps, warmup_steps=1, sharding=sharding)
    res = {}
    res["ref_one"] = trace(
        jax.jit(jtrain.make_train_step(jmodel, JTrainConfig(**kw), None)),
        jtrain.TrainState(params, jinit_state(params)), jbs)
    step_fn, shard_state, bshard = jtrain.build_jit_train_step(
        jmodel, JTrainConfig(**kw), jm, paxes, jbatch_axes(jc))
    st_sh, b_sh = shard_state(params), bshard(jbs[0])
    res["ref_mesh"] = trace(
        jax.jit(step_fn, in_shardings=(st_sh, b_sh)),
        jax.device_put(jtrain.TrainState(params, jinit_state(params)), st_sh),
        jbs, lambda b: jax.device_put(b, b_sh))
    model = from_jax_params(tree, tc, "cpu", param_dtype=torch.float32)
    res["one"] = trace(ttrain.make_train_step(model, TrainConfig(**kw)),
                       ttrain.train_state(model), tbs)
    model = from_jax_params(tree, tc, "cpu", param_dtype=torch.float32)
    tm = make_test_mesh(shape, axes, devices="cpu")
    step, tshard, _ = ttrain.build_train_step(
        model, TrainConfig(**kw), tm, params_axes(model),
        batch_logical_axes(tc))
    res["mesh"] = trace(step, ttrain.train_state(
        model, tshard(dict(model.named_parameters()))), tbs)
    out[sharding] = res
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def drift_results(tmp_path_factory):
    return run_device_subprocess(
        DRIFT_CHILD, args=[str(DRIFT_B), str(DRIFT_S), str(DRIFT_STEPS)],
        tmp_path=tmp_path_factory.mktemp("drift"), timeout=900)


def _apart(a, b, i):
    """Each step's relative distance of metric ``i`` (0 loss, 1
    grad_norm) of run ``a`` from run ``b``."""
    return [abs(x[i] - y[i]) / abs(y[i]) for x, y in zip(a, b)]


@pytest.mark.mesh
@pytest.mark.parametrize("sharding", ["fsdp", "tp"])
def test_placed_steps_leave_one_device_as_the_reference_does(drift_results,
                                                             sharding):
    """Eight steps of reduced llama3.2-3b in bf16 activations over (2, 4)
    CPU ranks: the port's placed step (``mesh``), its one-device step
    (``one``), the reference's jitted sharded step (``ref_mesh``) and its
    jitted one-device step (``ref_one``) from the same weights and
    batches.  A partitioned step rounds other bf16 products than one
    device does (a rank's partial weight grads, a column or contraction
    block's products), and Adam carries the difference on, so its losses
    and grad_norms leave one device's step by more than the one-step
    tolerances over a few steps: the reference's own do (step 0's
    ``"tp"`` loss 1.9e-5 apart, grad_norms up to 1.6e-3 apart by step 4
    in ``"fsdp"``).  Held: at every step, and at step 0 alone, the port's
    placed step is no further from the port's one-device step than
    DRIFT_FACTOR times the reference's sharded step is from the
    reference's one-device step, and no further from the reference's
    sharded step than DRIFT_FACTOR times the two one-device steps are
    from each other (each a floor of 1e-6)."""
    r = drift_results[sharding]
    for i in (0, 1):
        mine = _apart(r["mesh"], r["one"], i)
        ref = _apart(r["ref_mesh"], r["ref_one"], i)
        ones = _apart(r["one"], r["ref_one"], i)
        across = _apart(r["mesh"], r["ref_mesh"], i)
        # the readings (pytest -s): step 0's and the largest distance
        print(f"{sharding} {('loss', 'grad_norm')[i]}: placed / one "
              f"{mine[0]:.2e} {max(mine):.2e}, reference's mesh / one "
              f"{ref[0]:.2e} {max(ref):.2e}, the two one-device steps "
              f"{max(ones):.2e}, placed / reference's mesh "
              f"{max(across):.2e}")
        assert mine[0] <= DRIFT_FACTOR * ref[0] + 1e-6, (i, mine, ref)
        assert max(mine) <= DRIFT_FACTOR * max(ref) + 1e-6, (i, mine, ref)
        assert max(across) <= DRIFT_FACTOR * max(ones) + 1e-6, \
            (i, across, ones)


# ---------------------------------------------------------------------------
# attention_train over a mesh
# ---------------------------------------------------------------------------

#: name -> (mesh shape, axes, rules, strategy, B, S, H, KVH, prefix, the
#: blocks it runs (count), the q shape of each block)
ATTN_CASES = {
    "heads, K/V sharded": ((2, 4), ("data", "model"), "default", "heads",
                           2, 16, 8, 4, 0, 8, (1, 16, 2)),
    "heads, K/V replicated, straddling a group": (
        (2, 4), ("data", "model"), "default", "heads", 2, 16, 12, 3, 0, 8,
        (1, 16, 3)),
    "heads, inside a group": ((4,), ("model",), "default", "heads", 2, 16,
                              8, 2, 0, 4, (2, 16, 2)),
    "seq": ((2, 4), ("data", "model"), "default", "seq", 2, 16, 6, 2, 0, 8,
            (1, 4, 6)),
    "seq, prefix-LM": ((4,), ("model",), "default", "seq", 2, 16, 6, 3, 5,
                       4, (2, 4, 6)),
    "seq, 4 does not divide S": ((4,), ("model",), "default", "seq", 2, 18,
                                 6, 2, 0, 1, (2, 18, 6)),
    "fsdp, batch over every axis": ((2, 4), ("data", "model"), "fsdp",
                                    "heads", 8, 16, 8, 4, 0, 8, (1, 16, 8)),
    "fsdp, batch over data": ((2, 4), ("data", "model"), "fsdp", "heads",
                              2, 16, 8, 4, 0, 2, (1, 16, 8)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_train_over_mesh_matches_whole_call(case, monkeypatch):
    shape, axes, rule_set, strategy, B, S, H, KVH, prefix, n_blocks, \
        block_q = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    D = 8
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, D)),
                            dtype=torch.float32, requires_grad=True)
               for h in (H, KVH, KVH))
    dout = torch.tensor(rng.standard_normal((B, S, H, D)),
                        dtype=torch.float32)
    pos = torch.arange(S).expand(B, S)
    info = tatt.MaskInfo(True, prefix)
    whole = tatt.attention_train(q, k, v, pos, info, kv_chunk=8)
    gw = torch.autograd.grad((whole * dout).sum(), (q, k, v))
    blocks = []
    flash = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention", lambda *a, **kw: (
        blocks.append(tuple(a[0].shape[:3])) or flash(*a, **kw)))
    mesh = tmesh.make_test_mesh(shape, axes, devices="cpu")
    table = {"default": rules.DEFAULT_RULES, "fsdp": rules.FSDP_RULES}
    with rules.use_rules(table[rule_set]):
        qsh, ksh = tatt.placed_qkv_shardings(mesh, strategy, B, S, H, KVH)
        got = tatt.attention_train_placed(
            tmesh.map_blocks(qsh, (B, S, H * D), lambda b, sl, r: tmesh.take(
                q.reshape(B, S, H * D), r, sl, mesh=mesh)),
            *(tmesh.map_blocks(ksh, (B, S, KVH * D),
                               lambda b, sl, r, _t=t: tmesh.take(
                                   _t.reshape(B, S, KVH * D), r, sl,
                                   mesh=mesh)) for t in (k, v)),
            tmesh.place(pos, tmesh.Sharding(mesh, qsh.spec[:2])), H, KVH, D,
            info, kv_chunk=8)
    out = tmesh.gather(got).reshape(B, S, H, D)
    gm = torch.autograd.grad((out * dout).sum(), (q, k, v))
    assert len(blocks) == n_blocks and set(blocks) == {block_q}, blocks
    np.testing.assert_allclose(out.detach().numpy(), whole.detach().numpy(),
                               atol=1e-6)
    for a, b in zip(gm, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_attention_strategy_follows_the_heads():
    """``decoder_stack_train`` asks ``attn_strategy``: 24 heads over a
    ``model`` axis of 4 take ``"heads"``, 6 over 4 ``"seq"``."""
    mesh = tmesh.make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    assert rules.attn_strategy(24, mesh) == "heads"
    assert rules.attn_strategy(6, mesh) == "seq"


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

#: (mesh shape, axes, spec, shape, distinct blocks)
PLACE_CASES = [
    ((2, 4), ("data", "model"), (("data", "model"),), (16, 6), 8),
    ((2, 4), ("data", "model"), ("data", "model"), (6, 8), 8),
    ((2, 4), ("data", "model"), (None, "model"), (6, 8), 4),
    ((2, 4), ("data", "model"), ("model",), (8,), 4),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model"),
     (4, 3, 6), 8),
    ((4,), ("model",), (None, None), (5, 3), 1),
    ((2, 4), ("data", "model"), (), (), 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axes,spec,tshape,n", PLACE_CASES)
def test_place_gather_round_trip_is_bitwise(shape, axes, spec, tshape, n,
                                            dtype):
    """Each distinct block is stored once, by the lowest rank whose
    coordinates select it, on that rank's device; a spec that shards
    nothing keeps one tensor; gathering gives the bits back."""
    mesh = tmesh.make_test_mesh(shape, axes, devices="cpu")
    x = torch.randn(tshape).to(dtype)
    sh = tmesh.Sharding(mesh, spec)
    placed = tmesh.place(x, sh)
    assert len(tmesh.pieces(placed)) == n
    assert sum(tmesh.rank_bytes([placed], mesh)) == \
        x.numel() * x.element_size()
    if n > 1:
        owners = sh.owners()
        for rank in range(mesh.size):
            b = sh.block_of(rank)
            assert owners[b] <= rank
        for b, t in placed.blocks.items():
            assert t.is_contiguous()
            assert torch.equal(t, x[sh.slices(b, x.shape)])
            assert t.data_ptr() != x.data_ptr()
    back = tmesh.gather(placed)
    assert back.dtype == dtype and back.shape == x.shape
    assert back.reshape(-1).view(torch.uint8).numpy().tobytes() == \
        x.reshape(-1).view(torch.uint8).numpy().tobytes()
    bf = tmesh.gather(placed, "cpu", torch.bfloat16)
    assert torch.equal(bf, x.to(torch.bfloat16))


def test_tree_shardings_resolve_axes_and_pool_specs():
    """Logical-axis leaves resolve under the active rules with their dims
    (a dim the axes do not divide stays whole); a ``PoolSpec`` leaf
    resolves through ``pool_partition_spec``, as the reference's."""
    from repro.models.paged import pool_partition_spec as jpps
    import types
    mesh = tmesh.make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    jm = types.SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 2, "model": 4})
    values = {"w": torch.zeros(8, 12), "odd": torch.zeros(3, 6),
              "pool": torch.zeros(2, 16, 4), "ring": torch.zeros(2, 3, 4)}
    axes = {"w": ("embed", "ffn"), "odd": ("embed", "ffn"),
            "pool": PoolSpec("k", 16, sharding=None),
            "ring": PoolSpec("r", 3, sharding=())}
    sh = tmesh.tree_shardings(mesh, values, axes, block_axis=1)
    assert sh["w"].spec == ("data", "model")
    assert sh["odd"].spec == (None, None)
    def one_axis(e):
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e

    for name, hint in (("pool", None), ("ring", ())):
        want = tuple(jpps(jm, JPoolSpec(name, 4, sharding=hint),
                          block_axis=1))
        assert tuple(one_axis(e) for e in sh[name].spec) == want
    with rules.use_rules(rules.FSDP_RULES):
        fs = tmesh.tree_shardings(mesh, values, axes, block_axis=1)
    assert fs["w"].spec == (("data", "model"), None)


# ---------------------------------------------------------------------------
# the parameters' logical axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-72b",
                                  "deepseek-moe-16b", "paligemma-3b",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_params_axes_table_matches_split_params(arch):
    """``weights.params_axes`` gives every parameter the reference's axes
    from ``split_params(model.init_params(key))[1]``, looked up through
    ``weights.jax_path``; a stacked leaf's leading ``"layers"`` dropped."""
    _, ref_axes = split_params(build_model(
        jget_config(arch).reduced()).init_params(jax.random.key(0)))
    model = init_params(get_config(arch).reduced(), 0, "cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    table = params_axes(model)
    assert list(table) == list(shapes)
    for name, axes in table.items():
        path, idx = jax_path(name)
        want = ref_axes
        for key in path:
            want = want[key]
        if idx is not None:
            assert want[0] == "layers"
            want = want[1:]
        assert axes == tuple(want), name
        assert len(axes) == len(shapes[name]), name
