"""The port's training forward against the JAX package, on the CPU:

* ``chunked_softmax_xent``: value and grads against the reference's on
  bf16-valued inputs, with a padded last chunk and a partial mask (the
  logits are bf16 products read as fp32 on both sides, the sums fp32 in
  another order: rtol 1e-5 on the loss; grads of bf16 products within 2%
  of the largest entry, a few bf16 ulps);
* the training ``flash_attention``: values and grads against the
  reference's model function for causal, prefix-LM, several KV chunks and
  cross-attention with Sq != Skv (fp32 online softmax in another order:
  atol 1e-5 on unit-scale outputs, grads atol 1e-4);
* ``LanguageModel.loss_fn`` and its grads for every family (and a QKV-bias
  config), from ``from_jax_params(..., param_dtype=float32)``, against
  ``jax.value_and_grad`` of the reference's loss under ``cast_bf16``: the
  loss within 1e-4 (fp32 over 4 layers; the Mamba2 families' conv and
  SSD scan sum in another order), the aux loss within 1e-5 relative, each
  leaf's grad within 3% of the leaf's largest |grad| (the grads of the
  matrices are the cotangents of their bf16 views, summed in bf16 in
  another order: a few bf16 ulps of 2^-8);
* the remat policies give the same loss and grads (recomputation repeats
  the same operations).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_contract import one_thread, jax_and_port_models

from repro.models import attention as jatt
from repro.models import common as jcommon
from repro_torch.configs import TrainConfig
from repro_torch.data import make_batch, to_device
from repro_torch.launch.train import loss_and_grads, train_state
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcommon
from repro_torch.weights import jax_path

pytestmark = pytest.mark.usefixtures("one_thread")

#: the configs whose loss and grads this file checks; the Mamba2 families
#: and the encdec are in tests/test_torch_train_families.py (the files
#: run on separate workers)
LOSS_ARCHS = ("llama3.2-3b", "deepseek-moe-16b", "paligemma-3b",
              "qwen2-72b")


def _bf16_vals(rng, shape, scale=1.0):
    """fp32 values that bf16 holds exactly."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(50, 16), (64, 512), (96, 32)])
def test_chunked_softmax_xent_matches_reference(S, chunk):
    """S = 50 over chunks of 16 pads to 51 (3 chunks of 17); 64 is one
    chunk; 96 three exact chunks."""
    rng = np.random.default_rng(S)
    B, D, V = 2, 32, 96
    x = _bf16_vals(rng, (B, S, D))
    w = _bf16_vals(rng, (D, V), 0.2)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)

    def jloss(x, w):
        return jcommon.chunked_softmax_xent(x, w, jnp.asarray(labels),
                                            jnp.asarray(mask), chunk=chunk)

    jl, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tl = tcommon.chunked_softmax_xent(tx, tw, torch.tensor(labels),
                                      torch.tensor(mask), chunk=chunk)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            2e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the training attention
# ---------------------------------------------------------------------------

ATT_CASES = [
    # (Sq, Skv, H, KVH, causal, prefix_len, kv_chunk)
    (24, 24, 4, 2, True, 0, 512),
    (48, 48, 4, 1, True, 0, 16),       # three KV chunks, MQA
    (40, 40, 4, 4, True, 8, 16),       # prefix-LM over 2 chunks of 20
    (12, 30, 4, 2, False, 0, 512),     # cross-attention, Sq != Skv
]


@pytest.mark.parametrize("case", ATT_CASES)
def test_flash_attention_matches_reference(case):
    Sq, Skv, H, KVH, causal, prefix, kv_chunk = case
    rng = np.random.default_rng(Sq + Skv)
    B, D = 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    if causal:
        pq = pk = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    else:
        pq = np.zeros((B, Sq), np.int32)
        pk = np.zeros((B, Skv), np.int32)
    valid = np.ones((B, Skv), bool)
    dout = rng.standard_normal((B, Sq, H, D)).astype(np.float32)

    def jfn(q, k, v):
        o = jatt.flash_attention(q, k, v, jnp.asarray(pq), jnp.asarray(pk),
                                 jnp.asarray(valid),
                                 jatt.MaskInfo(causal, prefix), kv_chunk)
        return jnp.sum(o * dout), o

    (_, jo), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = tatt.flash_attention(tq, tk, tv, torch.tensor(pq).long(),
                              torch.tensor(pk).long(), torch.tensor(valid),
                              tatt.MaskInfo(causal, prefix), kv_chunk)
    (to * torch.tensor(dout)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_attention_train_is_causal_flash_and_takes_a_mesh():
    """On one device the call is ``flash_attention`` with every key valid;
    over (2, 4) CPU ranks the placed training attention runs it by blocks
    (the cases are in ``tests/test_torch_mesh_train.py`` and
    ``tests/test_torch_placed_train.py``) to the same values."""
    from repro_torch.launch.mesh import make_test_mesh, gather, place
    from repro_torch.sharding import rules
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((2, 8, 4, 16)), dtype=torch.float32)
    pos = torch.arange(8).expand(2, 8)
    info = tatt.MaskInfo(True, 0)
    out = tatt.attention_train(q, q, q, pos, info)
    want = tatt.flash_attention(q, q, q, pos, pos,
                                torch.ones((2, 8), dtype=torch.bool), info)
    assert torch.equal(out, want)
    mesh = make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    with rules.use_rules(rules.DEFAULT_RULES):
        qsh, ksh = tatt.placed_qkv_shardings(mesh, "heads", 2, 8, 4, 4)
    flat = q.reshape(2, 8, 64)
    got = tatt.attention_train_placed(
        place(flat, qsh), place(flat, ksh), place(flat, ksh),
        place(pos, type(qsh)(mesh, qsh.spec[:2])), 4, 4, 16, info)
    np.testing.assert_allclose(gather(got).reshape(2, 8, 4, 16).numpy(),
                               want.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the loss and its grads, every family
# ---------------------------------------------------------------------------

def cast_bf16(params):
    """The reference's ``launch/train.py`` cast (a nested function there)."""
    return jax.tree_util.tree_map(
        lambda p: p.astype(jnp.bfloat16)
        if p.dtype == jnp.float32 and p.ndim > 1 else p, params)


def port_value_and_grad(model, batch, remat="minimal"):
    """(total, metrics, {name: grad}) of the port's loss under its bf16
    views (the train step's ``grads_of``)."""
    state = train_state(model)
    return loss_and_grads(model, state.params, batch,
                          TrainConfig(remat_policy=remat))


def leaf(tree, name):
    path, idx = jax_path(name)
    for k in path:
        tree = tree[k]
    return np.asarray(tree if idx is None else np.asarray(tree)[idx])


def check_loss_and_grads(arch):
    """The port's loss, aux loss and grads against ``jax.value_and_grad``
    of the reference's loss under ``cast_bf16``, from the same weights and
    the same batch (B = 2, S = 64)."""
    jmodel, params, _, cfg = jax_and_port_models(arch)
    from repro.data import make_batch as jmake_batch
    batch = jmake_batch(jmodel.cfg, 2, 64, 3)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(cast_bf16(p), b, None, remat="minimal"),
        has_aux=True))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    from repro_torch.weights import from_jax_params
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu", param_dtype=torch.float32)
    tbatch = make_batch(cfg, 2, 64, 3)
    assert all(tbatch[k].tobytes() == batch[k].tobytes() for k in batch)
    total, metrics, grads = port_value_and_grad(model,
                                                to_device(tbatch, "cpu"))
    assert float(total) == pytest.approx(float(jl), abs=1e-4)
    assert float(metrics["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   abs=1e-4)
    assert float(metrics["aux"]) == pytest.approx(float(jmet["aux"]),
                                                  rel=1e-5, abs=1e-7)
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    jg = jax.tree_util.tree_map(np.asarray, jg)
    assert len(grads) == sum(
        np.asarray(a).shape[0] if path[0].key in ("layers", "enc_layers")
        else 1 for path, a in jax.tree_util.tree_leaves_with_path(jg))
    for name, g in grads.items():
        want = leaf(jg, name)
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        assert np.abs(g.numpy() - want).max() <= \
            3e-2 * np.abs(want).max() + 1e-7, name


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def test_remat_policies_agree():
    """"none", "minimal" and "dots" recompute the same operations: the
    same loss and grads to fp32 rounding (rtol 1e-6 on the loss, atol
    1e-6 on the grads)."""
    _, params, _, cfg = jax_and_port_models("zamba2-2.7b")
    from repro_torch.weights import from_jax_params
    batch = to_device(make_batch(cfg, 2, 64, 1), "cpu")
    out = {}
    for remat in ("none", "minimal", "dots"):
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu", param_dtype=torch.float32)
        out[remat] = port_value_and_grad(model, batch, remat)
    for remat in ("minimal", "dots"):
        assert float(out[remat][0]) == pytest.approx(float(out["none"][0]),
                                                     rel=1e-6)
        for n, g in out[remat][2].items():
            np.testing.assert_allclose(g.numpy(),
                                       out["none"][2][n].numpy(), atol=1e-6)
