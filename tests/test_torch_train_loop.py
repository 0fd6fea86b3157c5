"""The port's train step and loop against the JAX package, on the CPU, at
llama3.2-3b reduced (4 layers, d_model 128; fp32 activations meeting
bf16-rounded weights, as the reference's ``cast_bf16``):

* one ``make_train_step`` step, with one microbatch and with two, from the
  same fp32 master weights on the same batch: the metrics and every
  updated parameter and moment.  Tolerances: loss rtol 1e-5 (fp32 sums in
  another order); ``grad_norm`` rtol 1e-3 (the norm of grads that are
  bf16 cotangents summed in another order); each updated weight within
  2e-6 + 1e-2 x lr of the reference's where its grad is clear of the
  grads' 3% tolerance, else within 2 lr (Adam's first step moves a weight
  by about lr x sign(g): a grad within its error of zero may step either
  way); each moment within 3% of the leaf's largest;
* a 20-step ``train_loop`` loss trajectory from the reference's initial
  weights against the reference's ``train_loop``: rtol 1e-4 (2e-5 seen);
* a training step of every family with the kernels' wrappers and plain
  versions of attention and SSD (``kernels/ops.py``, ``kernels/ref.py``)
  made to raise: training calls no kernel and no kernel's plain version;
* a step over a mesh of CPU ranks against one device's (the reference's
  mesh step is held in ``tests/test_torch_mesh_train.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_contract import one_thread, jax_and_port_models

from repro.configs import TrainConfig as JTrainConfig
from repro.data import make_batch as jmake_batch
from repro.launch import train as jtrain
from repro.optim import init_state as jinit_state
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import make_batch, to_device
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.weights import from_jax_params, init_params, jax_path

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-3


def _leaf(tree, name):
    path, idx = jax_path(name)
    for k in path:
        tree = tree[k]
    return np.asarray(tree if idx is None else np.asarray(tree)[idx])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_matches_reference(microbatches):
    jmodel, params, _, cfg = jax_and_port_models("llama3.2-3b")
    kw = dict(total_steps=8, warmup_steps=1, learning_rate=LR,
              microbatches=microbatches)
    jstep = jax.jit(jtrain.make_train_step(jmodel, JTrainConfig(**kw), None))
    batch = jmake_batch(jmodel.cfg, 4, 64, 0)
    jstate, jm = jstep(jtrain.TrainState(params, jinit_state(params)),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu", param_dtype=torch.float32)
    step = ttrain.make_train_step(model, TrainConfig(**kw))
    state, tm = step(ttrain.train_state(model),
                     to_device(make_batch(cfg, 4, 64, 0), "cpu"))
    assert sorted(tm) == sorted(jm)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-3)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    if microbatches == 1:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert int(state.opt.step) == int(jstate.opt.step) == 1
    jp = jax.tree_util.tree_map(np.asarray, jstate.params)
    jmom = jax.tree_util.tree_map(np.asarray, jstate.opt.m)
    for name, p in state.params.items():
        # after one step m = (1 - b1) g: where the reference's grad is
        # within the grads' tolerance of zero the two sides' Adam steps
        # (about lr x sign(g)) may point opposite ways, at most 2 lr apart
        m_ref = _leaf(jmom, name)
        firm = np.abs(m_ref) > 3e-2 * np.abs(m_ref).max()
        diff = np.abs(p.detach().numpy() - _leaf(jp, name))
        assert diff[firm].max(initial=0) <= 2e-6 + 1e-2 * LR, name
        assert diff.max() <= 2e-6 + 2 * LR, name
    for mine, theirs in ((state.opt.m, jstate.opt.m),
                         (state.opt.v, jstate.opt.v)):
        theirs = jax.tree_util.tree_map(np.asarray, theirs)
        for name, t in mine.items():
            want = _leaf(theirs, name)
            assert np.abs(t.numpy() - want).max() <= \
                3e-2 * np.abs(want).max() + 1e-12, name


def test_train_loop_trajectory_matches_reference():
    _, jlosses = jtrain.train_loop("llama3.2-3b", steps=20, batch=2,
                                   seq_len=64, smoke=True, log_every=100)
    _, params, _, cfg = jax_and_port_models("llama3.2-3b")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu", param_dtype=torch.float32)
    _, losses = ttrain.train_loop("llama3.2-3b", steps=20, batch=2,
                                  seq_len=64, smoke=True, log_every=100,
                                  device="cpu", model=model)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def _raise(*args, **kwargs):
    raise AssertionError("training reached a kernel or its plain version")


#: the kernels' attention and SSD entries and their plain versions
KERNEL_ENTRIES = ((ops, "flash_attention"), (ops, "paged_attention_slab"),
                  (ops, "ssd_intra_chunk"), (ref, "flash_attention"),
                  (ref, "paged_attention_slab"), (ref, "ssd_intra_chunk"))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "paligemma-3b", "mamba2-780m",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_training_calls_no_kernel(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    model = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    batch = to_device(make_batch(cfg, 2, 64, 0), "cpu")
    # the prefill of the same model does reach them
    calls = []
    for mod, name in KERNEL_ENTRIES[:3]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, **k:
                            calls.append(1) or _f(*a, **k))
    if cfg.family in ("dense", "moe"):
        model.prefill(batch["tokens"])
    else:
        kw = {k: batch[k] for k in ("patch_embeds", "src_embeds")
              if k in batch}
        model.prefill_state(batch["tokens"], **kw)
    assert calls
    for mod, name in KERNEL_ENTRIES:
        monkeypatch.setattr(mod, name, _raise)
    step = ttrain.make_train_step(model, TrainConfig(warmup_steps=1,
                                                     total_steps=4))
    _, metrics = step(ttrain.train_state(model), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))


def test_make_train_step_over_a_mesh_holds_the_masters_once():
    """``make_train_step(mesh=)`` (what replaced its refusal): over (2, 4)
    CPU ranks with the state placed by ``build_train_step``'s
    ``shard_state``, one step gives one device's loss (rtol 1e-5) and
    ``grad_norm`` (rtol 1e-3) and weights (the tolerance above); the
    model's own parameters are released and every fp32 master and moment
    is stored once over the ranks."""
    from repro_torch.data import batch_logical_axes
    from repro_torch.launch.mesh import gather, make_test_mesh, rank_bytes
    from repro_torch.weights import params_axes
    cfg = get_config("llama3.2-3b").reduced()
    kw = dict(total_steps=8, warmup_steps=1, learning_rate=LR)
    batch = to_device(make_batch(cfg, 4, 64, 0), "cpu")
    one = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    state1, m1 = ttrain.make_train_step(one, TrainConfig(**kw))(
        ttrain.train_state(one), batch)
    model = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    n_par = sum(p.numel() for p in model.parameters())
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    step, shard_state, _ = ttrain.build_train_step(
        model, TrainConfig(**kw), mesh, params_axes(model),
        batch_logical_axes(cfg))
    state = ttrain.train_state(model, shard_state(dict(
        model.named_parameters())))
    assert all(p.numel() == 0 for p in model.parameters())
    held = rank_bytes(list(state.params.values()) + list(state.opt.m.values())
                      + list(state.opt.v.values()), mesh)
    assert sum(held) == 3 * 4 * n_par and min(held) > 0
    state, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                  rel=1e-3)
    assert int(state.opt.step) == 1
    for name, p in state.params.items():
        diff = (gather(p) - state1.params[name]).detach().abs().max()
        assert float(diff) <= 2e-6 + 2 * LR, name
