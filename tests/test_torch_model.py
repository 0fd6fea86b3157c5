"""The port's dense model against the JAX model on the reduced dense
configurations (4 layers, d_model 128, fp32): llama3.2-3b, yi-6b (GQA
group 4 after the cut), mistral-nemo-12b and qwen2-72b, with the JAX
weights loaded through ``from_jax_params``.  qwen2-72b's QKV biases are
zero at init in both packages, so its ``bq`` / ``bk`` / ``bv`` are drawn
nonzero from a seed in the JAX tree before both packages load it.

Tolerances: KV pages atol 1e-4 (fp32; attention and matmuls sum in another
order).  Logits atol 4e-3: both heads are bf16 products (``lm.py:96``), so
each side rounds its logits to bf16, and a logit whose fp32 sums straddle
a rounding boundary differs by one bf16 ulp: at most 2**-8 = 3.9e-3 for
|logit| < 1, which every logit of these random weights is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import to_torch

from repro.configs import get_config as jget_config
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.models.lm import kv_to_pools
from repro_torch.weights import from_jax_params

LOGIT_ATOL = 4e-3
KV_ATOL = 1e-4


#: the dense configurations, reduced
DENSE_ARCHS = ("llama3.2-3b", "yi-6b", "mistral-nemo-12b", "qwen2-72b")
#: scale of the seeded QKV biases (the projections' outputs are O(1))
BIAS_SCALE = 0.5


def perturb_qkv_bias(tree, seed: int = 0):
    """Draw the (stacked) ``bq`` / ``bk`` / ``bv`` of a numpy parameter
    tree from a seed, in place."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (rng.standard_normal(attn[name].shape) *
                      BIAS_SCALE).astype(attn[name].dtype)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def models(request):
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jmodel = build_model(jcfg)
    params, _ = split_params(jmodel.init_params(jax.random.key(0)))
    tree = jax.tree_util.tree_map(np.array, params)
    if jcfg.qkv_bias:
        perturb_qkv_bias(tree)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = get_config(arch).reduced()
    return jmodel, params, from_jax_params(tree, cfg, device="cpu"), cfg


@pytest.mark.parametrize("S", [24, 70])
def test_prefill_logits_and_kv_pages(models, S):
    jmodel, params, tmodel, cfg = models
    prompt = np.random.default_rng(S).integers(2, cfg.vocab_size, (1, S))
    logits_j, st = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                                  None, margin_tokens=0)
    logits_t, k, v = tmodel.prefill(torch.from_numpy(prompt))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)
    page = tmodel.page
    nper = st["k_pools"].shape[1]
    for name, kv in (("k_pools", k), ("v_pools", v)):
        np.testing.assert_allclose(
            kv_to_pools(kv, page, torch.float32, nper).numpy(),
            np.asarray(st[name]), atol=KV_ATOL, rtol=1e-4, err_msg=name)


def test_decode_steps_over_paged_state(models):
    """Two decode steps over the paged state a batched prefill built (the
    identity block layout, one spare page per sequence): logits match and
    the appended K/V land in the same slots."""
    jmodel, params, tmodel, cfg = models
    prompts = np.random.default_rng(1).integers(2, cfg.vocab_size, (3, 30))
    logits_j, st = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                  None)
    kp, vp = to_torch(st["k_pools"]), to_torch(st["v_pools"])
    table, mask, base = (to_torch(st[n]) for n in
                         ("block_table", "share_mask", "base"))
    lens = to_torch(st["seq_lens"])
    tok = np.asarray(jnp.argmax(logits_j, -1), np.int32)
    for _ in range(2):
        logits_j, st = jmodel.decode_step(params, st, jnp.asarray(tok), None)
        logits_t = tmodel.decode_step(torch.from_numpy(tok.copy()).long(),
                                      lens, kp, vp, table, mask, base)
        lens = lens + 1
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(logits_j, -1), np.int32)
    np.testing.assert_allclose(kp.numpy(), np.asarray(st["k_pools"]),
                               atol=KV_ATOL, rtol=1e-4)
    np.testing.assert_allclose(vp.numpy(), np.asarray(st["v_pools"]),
                               atol=KV_ATOL, rtol=1e-4)


def test_init_params_is_seeded_and_scaled():
    """init_params draws from a torch.Generator: the same seed gives the
    same weights, another seed others; scales follow the reference's
    initialisers (embedding 0.02, dense 1/sqrt(in), norm gains 0)."""
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b").reduced()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a.layers[0].wq, b.layers[0].wq)
    assert not torch.equal(a.layers[0].wq, c.layers[0].wq)
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[1].w_down.std()) - cfg.d_ff ** -0.5) < 5e-3
    assert float(a.layers[2].ln1.abs().max()) == 0.0


def test_qkv_bias_is_loaded_and_applied(models):
    """qwen2-72b's seeded biases reach every layer and move q / k / v by
    exactly the bias; the other dense configs hold none."""
    _, _, tmodel, cfg = models
    layer = tmodel.layers[1]
    assert hasattr(layer, "bq") == cfg.qkv_bias
    if not cfg.qkv_bias:
        return
    assert float(layer.bq.abs().min()) > 0
    h = torch.zeros((1, 2, cfg.d_model))
    q, k, v = layer.qkv(h)
    for got, bias in ((q, layer.bq), (k, layer.bk), (v, layer.bv)):
        torch.testing.assert_close(got[0, 0], bias, atol=0, rtol=0)


def test_facade_pair_refuses_the_dense_family(models):
    """prefill_state / decode_state / make_serve_state are the ssm and
    hybrid families' entries (the reference's facade); the dense model
    runs through prefill / decode_step, which the serving engine drives,
    and the facade raises for it."""
    _, _, tmodel, _ = models
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        tmodel.prefill_state(tokens)
    with pytest.raises(NotImplementedError):
        tmodel.make_serve_state(1, 64)
    with pytest.raises(NotImplementedError):
        tmodel.decode_state({}, tokens[:, 0])
