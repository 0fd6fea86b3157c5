"""The port's moe training over a rank mesh, its elastic restore and its DP
all-reduce against the JAX package's, on the CPU (the dense, vlm and
encdec steps, ``attention_train`` and the placement are in
``tests/test_torch_mesh_train.py``):

* one ``make_train_step`` step of deepseek-moe-16b reduced with its
  published routing (64 experts, top 6) over ``("model",)`` 4 under
  ``"tp"`` (the all-to-all path) and ``("data",)`` 4 under ``"fsdp"``,
  against the reference's jitted step under the same mesh and shardings
  (the child and the tolerances of ``test_torch_mesh_train.py``): the same
  path in every layer, forward calls apart from backward's
  recomputations, and ``aux``;
* ``compress_psum_bf16`` / ``compress_psum_int8`` over ``("data",)`` and
  ``("data", "model")`` of a (2, 4) mesh against the reference's inside
  ``shard_map``, 10 feedback rounds (forced JAX host devices in a
  subprocess).  bf16: bitwise (XLA's all-reduce of bf16 sums in fp32 and
  rounds once, as the port does).  int8: the outputs of the first round
  bitwise (an int32 sum of equal int8 values), the residuals within 5e-8
  (XLA fuses ``g32 - q * scale`` into one multiply-add under ``jit``, the
  port rounds the product first, as the reference's arithmetic reads: at
  most half an ulp of the product, about 2e-9 at these grads, fed back
  each round);
* a checkpoint saved over 8 ranks restored through ``restore(shardings=)``
  / ``elastic_restore`` onto a (2, 2) mesh: every leaf bitwise and placed
  for the new mesh, and the loss one device's (the reference's
  ``tests/test_multidevice.py`` ``SCRIPT`` part 3), rtol 1e-5;
* ``plan_remesh`` against the reference's on the cases of
  ``tests/test_runtime.py`` and a grid; a run over 8 ranks that fails,
  re-meshed onto 4 and resumed from its checkpoint, against the run
  without a failure; ``run_with_restarts(shardings=)``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _meshproc import run_device_subprocess
from test_torch_contract import one_thread, jax_and_port_models  # noqa: F401
from test_torch_mesh_train import LOSS_RTOL, check_step, run_steps

from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_logical_axes, make_batch, to_device
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.runtime import (NodeFailure, RestartPolicy, build_mesh,
                                 elastic_restore, plan_remesh,
                                 run_with_restarts)
from repro_torch.weights import from_jax_params, init_params, params_axes

pytestmark = pytest.mark.usefixtures("one_thread")

ROUTING = {"num_experts": 64, "top_k": 6}
MOE_CASES = {
    "moe tp model 4": ("deepseek-moe-16b", (4,), ("model",), "tp", 2, 64,
                       ROUTING),
    "moe fsdp data 4": ("deepseek-moe-16b", (4,), ("data",), "fsdp", 4, 64,
                        ROUTING),
}
#: the path each case's every layer takes
MOE_PATH = {"moe tp model 4": "a2a", "moe fsdp data 4": "fsdp"}


@pytest.fixture(scope="module")
def moe_results(tmp_path_factory):
    return run_steps(MOE_CASES, tmp_path_factory.mktemp("moe_steps"))


@pytest.mark.mesh
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mesh_train_step_matches_reference(moe_results, case):
    """The step against the reference's, every layer's FFN through the
    reference's mesh path (forward calls counted apart from backward's
    recomputations), ``aux`` within 1e-5.  It is not one device's step:
    under the all-to-all a rank's capacity comes from its own tokens and
    other choices drop, so the loss differs; under FSDP each batch row
    routes alone as on one device, so the loss is one device's and the
    aux loss, the mean of the shards', differs."""
    r = moe_results[case]
    check_step(r)
    want = MOE_PATH[case]
    layers = get_config("deepseek-moe-16b").reduced().num_layers
    assert r["ref_paths"] == [want], r
    assert r["paths"] == {want: layers} == r["recomputed"], r
    np.testing.assert_allclose(*r["aux"], rtol=1e-5)
    local_loss, local_aux = r["local"]
    if want == "a2a":
        assert abs(local_loss - r["loss"][1]) > 1e-3, r
    else:
        np.testing.assert_allclose(local_loss, r["loss"][1], rtol=LOSS_RTOL)
        assert abs(local_aux - r["aux"][1]) > 1e-3 * abs(r["aux"][1]), r


# ---------------------------------------------------------------------------
# the DP all-reduce
# ---------------------------------------------------------------------------

COMPRESS_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P

import repro.optim.compress as jcompress
from repro.compat import shard_map
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import compress as tcompress

torch.set_num_threads(1)
SHAPES = {"a": (16, 8), "b": (33,)}
jm = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
tm = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
ALL = P(("data", "model"))
out = {}
for kind in ("bf16", "int8"):
    for dp_axes in (("data",), ("data", "model")):
        dp = int(np.prod([jm.shape[a] for a in dp_axes]))
        jfn = getattr(jcompress, f"compress_psum_{kind}")
        tfn = getattr(tcompress, f"compress_psum_{kind}")

        def body(g, e, _fn=jfn, _ax=dp_axes, _dp=dp):
            o, ne = _fn({k: v[0] for k, v in g.items()},
                        {k: v[0] for k, v in e.items()}, _ax, _dp)
            return ({k: v[None] for k, v in o.items()},
                    {k: v[None] for k, v in ne.items()})

        fn = jax.jit(shard_map(body, mesh=jm, in_specs=(ALL, ALL),
                               out_specs=(ALL, ALL), check_vma=False))
        rng = np.random.default_rng(3)
        jerr = {k: jnp.zeros((8,) + s, jnp.float32) for k, s in SHAPES.items()}
        terr = [{k: torch.zeros(s) for k, s in SHAPES.items()}
                for _ in range(8)]
        rounds = []
        for _ in range(10):
            g = {k: (rng.standard_normal((8,) + s) * 1e-2).astype(np.float32)
                 for k, s in SHAPES.items()}
            jout, jerr = fn({k: jnp.asarray(v) for k, v in g.items()}, jerr)
            tout, terr = tfn([{k: torch.tensor(v[r]) for k, v in g.items()}
                              for r in range(8)], terr, dp_axes, dp, mesh=tm)
            r = {"out_bitwise": True, "err_bitwise": True, "out_max": 0.0,
                 "err_max": 0.0, "out_scale": 0.0}
            for k in SHAPES:
                jo, je = np.asarray(jout[k]), np.asarray(jerr[k])
                to = np.stack([t[k].numpy() for t in tout])
                te = np.stack([t[k].numpy() for t in terr])
                r["out_bitwise"] &= to.tobytes() == jo.tobytes()
                r["err_bitwise"] &= te.tobytes() == je.tobytes()
                r["out_max"] = max(r["out_max"], float(np.abs(to - jo).max()))
                r["err_max"] = max(r["err_max"], float(np.abs(te - je).max()))
                r["out_scale"] = max(r["out_scale"], float(np.abs(jo).max()))
            rounds.append(r)
        out[f"{kind} {'+'.join(dp_axes)}"] = rounds
print("RESULTS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def compress_results(tmp_path_factory):
    return run_device_subprocess(COMPRESS_CHILD,
                                 tmp_path=tmp_path_factory.mktemp("dp"),
                                 timeout=600)


@pytest.mark.mesh
@pytest.mark.parametrize("case", ["bf16 data", "bf16 data+model",
                                  "int8 data", "int8 data+model"])
def test_compressed_all_reduce_matches_reference_shard_map(compress_results,
                                                           case):
    rounds = compress_results[case]
    assert len(rounds) == 10
    assert all(r["out_scale"] > 1e-3 for r in rounds)
    if case.startswith("bf16"):
        assert all(r["out_bitwise"] and r["err_bitwise"] for r in rounds)
    else:
        assert rounds[0]["out_bitwise"]
        assert max(r["err_max"] for r in rounds) <= 5e-8
        assert max(r["out_max"] for r in rounds) <= 5e-8


def test_dp_groups_span_the_dp_axes():
    mesh = tmesh.make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    from repro_torch.optim.compress import dp_groups
    assert dp_groups(mesh, ("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert dp_groups(mesh, ("data", "model")) == [list(range(8))]
    assert dp_groups(mesh, ()) == [[r] for r in range(8)]


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------

def _mesh_state(model, cfg, tcfg, mesh):
    step, shard, _ = ttrain.build_train_step(
        model, tcfg, mesh, params_axes(model), batch_logical_axes(cfg))
    return step, shard


def test_checkpoint_over_8_ranks_restores_onto_2x2(tmp_path):
    """A ``TrainState`` placed over (2, 2, 2) ranks is saved as whole
    arrays and restored onto (2, 2) by ``elastic_restore`` (the
    decision of ``plan_remesh`` for 4 survivors): every leaf bitwise equal
    to the saved one and placed by the new mesh's shardings, and the loss
    over (2, 2) one device's and the reference's under ``cast_bf16``."""
    jmodel, params, _, cfg = jax_and_port_models("yi-6b")
    tree = jax.tree_util.tree_map(np.asarray, params)
    tcfg = TrainConfig(total_steps=8, warmup_steps=1)
    mesh8 = tmesh.make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                 devices="cpu")
    model8 = from_jax_params(tree, cfg, "cpu", param_dtype=torch.float32)
    _, shard8 = _mesh_state(model8, cfg, tcfg, mesh8)
    state8 = ttrain.train_state(model8, shard8(dict(
        model8.named_parameters())))
    for i, m in enumerate(state8.opt.m.values()):
        for t in tmesh.pieces(m):
            t.fill_(0.25 * i)
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(3, state8)

    decision = plan_remesh(4, model_parallel=2, global_batch=4, old_dp=4)
    assert decision.mesh_shape == (2, 2)
    mesh4 = build_mesh(decision, "cpu")
    model4 = init_params(cfg, 1, "cpu", param_dtype=torch.float32)
    example = ttrain.train_state(model4)
    _, shard4 = _mesh_state(model4, cfg, tcfg, mesh4)
    state4, step = elastic_restore(ckpt, example, mesh4,
                                   lambda m: shard4(example.params))
    assert step == 3
    want = shard4(example.params)
    for live, back, sh in ((state8.params, state4.params, want.params),
                           (state8.opt.m, state4.opt.m, want.opt.m),
                           (state8.opt.v, state4.opt.v, want.opt.v)):
        for n in live:
            assert torch.equal(tmesh.gather(back[n]),
                               tmesh.gather(live[n]).detach()), n
            placed = back[n]
            if isinstance(placed, tmesh.Sharded):
                assert placed.sharding == sh[n], n
    batch = make_batch(cfg, 4, 64, 0)
    loss4, _, _ = ttrain.loss_and_grads(model4, state4.params,
                                        to_device(batch, "cpu"), tcfg, mesh4)
    one = from_jax_params(tree, cfg, "cpu", param_dtype=torch.float32)
    loss1, _, _ = ttrain.loss_and_grads(one, dict(one.named_parameters()),
                                        to_device(batch, "cpu"), tcfg)
    jloss, _ = jmodel.loss_fn(jax.tree_util.tree_map(
        lambda p: p.astype(jnp.bfloat16) if p.ndim > 1 else p, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss4), float(jloss), rtol=LOSS_RTOL)


def test_restore_with_shardings_places_each_leaf(tmp_path):
    """The reference's ``test_elastic_restore_resharding`` on the port: a
    checkpoint written once comes back placed by the shardings given."""
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
             "step": torch.tensor(5, dtype=torch.int32)}
    ckpt.save(1, state)
    mesh = tmesh.make_test_mesh((2, 2), ("data", "model"), devices="cpu")
    sh = {"w": tmesh.Sharding(mesh, ("data", "model")),
          "step": tmesh.Sharding(mesh, ())}
    example = {"w": torch.zeros(8, 8), "step": state["step"]}
    restored, step = ckpt.restore(example, shardings=sh)
    assert step == 1 and isinstance(restored["w"], tmesh.Sharded)
    assert len(restored["w"].blocks) == 4
    np.testing.assert_array_equal(tmesh.gather(restored["w"]).numpy(),
                                  state["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 5


def test_plan_remesh_matches_reference():
    """The reference's cases (``tests/test_runtime.py``) and a grid:
    the same decision, or the same error."""
    cases = [dict(n_devices=512, model_parallel=16, global_batch=256,
                  old_dp=32, multi_pod=True),
             dict(n_devices=256, model_parallel=16, global_batch=256,
                  old_dp=32),
             dict(n_devices=8, model_parallel=16, global_batch=256,
                  old_dp=32)]
    cases += [dict(n_devices=n, model_parallel=mp, global_batch=64,
                   old_dp=dp, multi_pod=pod)
              for n in (1, 3, 4, 6, 8, 12) for mp in (1, 2, 4)
              for dp in (1, 2, 8) for pod in (False, True)]
    for kw in cases:
        try:
            want = dataclasses.asdict(jelastic.plan_remesh(**kw))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                plan_remesh(**kw)
            continue
        got = dataclasses.asdict(plan_remesh(**kw))
        assert {k: tuple(v) if isinstance(v, list) else v
                for k, v in got.items()} == \
            {k: tuple(v) if isinstance(v, list) else v
             for k, v in want.items()}, kw


def test_elastic_resume_tracks_the_uninterrupted_run(tmp_path):
    """``train_loop`` over (2, 4) ranks fails at step 5 after a checkpoint
    at step 4; ``plan_remesh`` keeps the ``model`` axis on 4 survivors
    ((1, 4), 2 microbatches to keep the batch) and the run resumes from
    the checkpoint restored onto them: steps 4-7 within rtol 1e-4 of the
    run without a failure (the two halves' fp32 sums in another order)."""
    arch, B, S = "llama3.2-3b", 4, 64
    mesh8 = tmesh.make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    loop = dict(steps=8, batch=B, seq_len=S, log_every=100, mesh=mesh8,
                async_save=False)
    _, ref = ttrain.train_loop(arch, **loop)
    with pytest.raises(NodeFailure):
        ttrain.train_loop(arch, ckpt_dir=str(tmp_path), checkpoint_every=4,
                          inject_failure_at=5, **loop)
    decision = plan_remesh(4, model_parallel=4, global_batch=B, old_dp=2)
    assert decision.mesh_shape == (1, 4) and decision.microbatches == 2
    mesh4 = build_mesh(decision, "cpu")
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(total_steps=8, warmup_steps=1,
                       microbatches=decision.microbatches)
    model = init_params(cfg, 7, "cpu", param_dtype=torch.float32)
    example = ttrain.train_state(model)
    step, shard = _mesh_state(model, cfg, tcfg, mesh4)
    state, start = elastic_restore(CheckpointManager(str(tmp_path)), example,
                                   mesh4, lambda m: shard(example.params))
    assert start == 4
    losses = []
    for i in range(start, 8):
        state, m = step(state, to_device(make_batch(cfg, B, S, i), "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref[4:], rtol=1e-4)


def test_run_with_restarts_passes_the_shardings(tmp_path):
    """A restart restores the latest checkpoint placed by ``shardings``."""
    mesh = tmesh.make_test_mesh((4,), ("data",), devices="cpu")
    sh = {"w": tmesh.Sharding(mesh, ("data",))}
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    seen = []

    def loop(start, state):
        seen.append((start, state["w"]))
        if start == 0:
            ckpt.save(2, {"w": torch.arange(8.0)})
            raise NodeFailure("injected")
        return state

    out = run_with_restarts(loop, {"w": torch.zeros(8)}, ckpt,
                            RestartPolicy(max_restarts=1), shardings=sh)
    assert [s for s, _ in seen] == [0, 2]
    assert isinstance(out["w"], tmesh.Sharded)
    assert torch.equal(tmesh.gather(out["w"]), torch.arange(8.0))
