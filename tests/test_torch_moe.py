"""The port's moe family against the JAX package on the reduced
deepseek-moe-16b (64 experts top-6 with 2 shared, reduced to 4 experts
top-2 with 1 shared) and phi3.5-moe-42b-a6.6b (16 experts top-2, no shared
expert, reduced to 4 top-2): ``capacity``, ``route`` against
``_route_local``, ``moe_ffn_local`` against ``_moe_ffn_local`` (output and
aux loss), the moe ``LanguageModel``'s prefill and decode step, and a
scripted ``ServingEngine`` run.

Tolerances: the FFN's output atol 1e-4 in fp32 (sums in another order); in
bf16 atol 2e-2 plus rtol 2**-7 (one bf16 ulp of the value): the
reference's sigmoid on the CPU rounds to bf16 after each of its exp, add
and divide, torch's once, so 25-45% of the SwiGLU's hidden values differ
by an ulp; the down product sums them with cancellation, and the skewed
case below reads 2.34e-2 at y = 1.35 (the shared and the routed term each
1-2 ulps off).  The aux loss rtol 1e-5 (fp32 either way).  Model logits
atol 4e-3 and KV pages 1e-4, as ``test_torch_model.py``.

Routing is compared exactly: expert indices, positions and keep flags are
equal; in the routing test the gap between each token's k-th and (k+1)-th
probability is asserted above twice the probabilities' tolerance, so an
equal choice is not a coincidence of rounding.  The router's logits within
2e-5 and its probabilities and gates within 1e-6 (fp32 ulps; bf16 logits
come out equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import PortHook, jax_and_port_models, to_torch
from test_torch_serve import PROMPT_LENS, _JaxHook, _margin

import repro.models.moe as jmoe
from repro.configs import get_config as jget_config
from repro.launch.serve import ServingEngine as JServing
from repro.models import split_params
from repro_torch.configs import get_config
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import moe
from repro_torch.models.lm import kv_to_pools

ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
#: dtype -> (torch dtype, jax dtype, atol, rtol) of the FFN's output
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4, 0.0),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 2.0 ** -7)}
LOGIT_ATOL = 4e-3
KV_ATOL = 1e-4
#: prompt seed of the serving script; random weights give near-uniform
#: logits, and with this seed every greedy step of the reduced
#: deepseek-moe-16b keeps a top-1 / top-2 margin above 2 x LOGIT_ATOL
MOE_PROMPT_SEED = 5
#: the router's tolerances: its logits agree to a few fp32 ulps (bf16
#: logits come out equal: both products round once), the fp32 softmax
#: probabilities and gates to a few ulps of 1
ROUTER_LOGIT_ATOL = 2e-5
PROB_ATOL = 1e-6


def _configs(arch, dtype="float32"):
    jc = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    tc = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return jc, tc


def _jax_moe_params(jc, seed=0):
    params, _ = split_params(jmoe.init_moe_ffn(jax.random.key(seed), jc))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_moe(tree, tc, dtype):
    m = moe.MoEFFN(tc, dtype, "cpu")
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(m, name).data.copy_(to_torch(tree[name]).to(dtype))
    if m.shared is not None:
        for name in ("w_gate", "w_up", "w_down"):
            getattr(m.shared, name).data.copy_(
                to_torch(tree["shared"][name]).to(dtype))
    return m


def _clear_topk(probs, k, atol):
    """Tokens whose k-th and (k+1)-th probabilities lie more than twice
    ``atol`` apart: both packages must make the same choices there."""
    top = np.sort(np.asarray(probs, np.float32), axis=-1)[..., ::-1]
    return top[..., k - 1] - top[..., k] > 2 * atol


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    for cfg_t, cfg_j in ((get_config(arch), jget_config(arch)),
                         _configs(arch)[::-1]):
        for S in (1, 7, 64, 250, 512, 4096):
            assert moe.capacity(cfg_t, S) == jmoe.capacity(cfg_j, S), S
    assert moe.CAPACITY_FACTOR == jmoe.CAPACITY_FACTOR
    # deepseek at one 512-token prompt: 64 slots against a mean load of 48
    if arch == "deepseek-moe-16b":
        assert moe.capacity(get_config(arch), 512) == 64
        assert moe.capacity(get_config(arch), 1) == 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    """``route`` on one row of N tokens against ``_route_local`` on the
    same N tokens: equal indices, positions and keep flags, gates and
    probabilities within tolerance.  C = 8 < the mean load, so choices
    drop."""
    jc, tc = _configs(arch, dtype)
    tdt, jdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(3)
    N, E, k, C = 40, tc.num_experts, tc.top_k, 8
    x = rng.standard_normal((N, tc.d_model)).astype(np.float32)
    wr = (rng.standard_normal((tc.d_model, E)) * 0.3).astype(np.float32)
    gj, ij, pj, kj, prj, lj = jmoe._route_local(
        jnp.asarray(x).astype(jdt), jnp.asarray(wr), E, k, C)
    gt, it, pt, kt, prt, lt = moe.route(
        torch.from_numpy(x).to(tdt)[None], torch.from_numpy(wr), k, C)
    assert _clear_topk(prj, k, PROB_ATOL).all()
    np.testing.assert_array_equal(it[0].numpy(), np.asarray(ij))
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt[0].numpy(), np.asarray(kj))
    assert not kt.all(), "C = 8 should drop choices"
    np.testing.assert_allclose(prt[0].numpy(), np.asarray(prj),
                               atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj),
                               atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(lt[0].numpy(), np.asarray(lj),
                               atol=ROUTER_LOGIT_ATOL, rtol=0)


def _ffn_parity(arch, dtype, x, tree=None, skew=0.0):
    """``moe_ffn_local`` of both packages on ``x`` (B, S, d); ``skew`` is
    added to the router weight from feature 0 to expert 0.  Returns the
    port's routing."""
    jc, tc = _configs(arch, dtype)
    tdt, jdt, atol, rtol = DTYPES[dtype]
    tree = _jax_moe_params(jc) if tree is None else tree
    tree["router"] = tree["router"].copy()
    tree["router"][0, 0] += skew
    yj, auxj = jmoe._moe_ffn_local(tree, jnp.asarray(x).astype(jdt), jc,
                                   None)
    m = _port_moe(tree, tc, tdt)
    seen = {}

    def keep_idx(idx):
        seen["idx"] = idx
        return idx

    moe.ROUTE_HOOK = keep_idx
    try:
        yt, auxt = moe.moe_ffn_local(m, torch.from_numpy(x).to(tdt), tc)
    finally:
        moe.ROUTE_HOOK = None
    assert yt.dtype == tdt and tuple(yt.shape) == x.shape
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj).astype(np.float32), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    # the same routing as the reference's
    C = moe.capacity(tc, x.shape[1])
    xj = jnp.asarray(x).astype(jdt)
    logits = (xj @ jnp.asarray(tree["router"]).astype(jdt)).astype(
        jnp.float32)
    _, idx_j = jax.lax.top_k(jax.nn.softmax(logits, -1), tc.top_k)
    np.testing.assert_array_equal(seen["idx"].numpy(), np.asarray(idx_j))
    return moe.route(torch.from_numpy(x).to(tdt), m.router, tc.top_k, C)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_local_matches_reference(arch, dtype):
    """B = 2 rows of S = 24 tokens (decode-sized C = 16), the reference's
    initial weights: output and aux loss within tolerance, equal top-k."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 128)).astype(np.float32)
    _ffn_parity(arch, dtype, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_under_a_skewed_router(arch, dtype):
    """A router skewed to expert 0 overflows its capacity in both batch
    rows: choices drop (add zero into slot C-1, gathered with weight 0)
    and the output still matches the reference's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 128)).astype(np.float32)
    x[:, :, 0] = np.abs(x[:, :, 0]) + 1.0
    _, idx, pos, keep, _, _ = _ffn_parity(arch, dtype, x, skew=4.0)
    C = moe.capacity(_configs(arch)[1], 32)
    dropped = ~keep
    assert dropped[0].any() and dropped[1].any(), "no choice dropped"
    assert (idx[dropped] == 0).all()
    assert (pos[dropped] == C - 1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_logits_and_kv_pages(arch):
    jmodel, params, tmodel, cfg = jax_and_port_models(arch)
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, (1, 70))
    logits_j, st = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                                  None, margin_tokens=0)
    logits_t, k, v = tmodel.prefill(torch.from_numpy(prompt))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)
    nper = st["k_pools"].shape[1]
    for name, kv in (("k_pools", k), ("v_pools", v)):
        np.testing.assert_allclose(
            kv_to_pools(kv, tmodel.page, torch.float32, nper).numpy(),
            np.asarray(st[name]), atol=KV_ATOL, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_steps_over_paged_state(arch):
    """Three decode steps over a batched prefill's paged state: each
    sequence routes alone (C = 8), logits and appended K/V match."""
    jmodel, params, tmodel, cfg = jax_and_port_models(arch)
    prompts = np.random.default_rng(1).integers(2, cfg.vocab_size, (3, 30))
    logits_j, st = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                  None)
    kp, vp = to_torch(st["k_pools"]), to_torch(st["v_pools"])
    table, mask, base = (to_torch(st[n]) for n in
                         ("block_table", "share_mask", "base"))
    lens = to_torch(st["seq_lens"])
    tok = np.asarray(jnp.argmax(logits_j, -1), np.int32)
    for _ in range(3):
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


def test_moe_aux_loss_reaches_the_layer():
    """decoder_layer_train returns the moe FFN's aux loss (0 for dense),
    for a training slice to sum."""
    from repro_torch.models.transformer import decoder_layer_train
    from repro_torch.weights import init_params
    x = torch.randn((1, 16, 128), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(16)[None]
    for arch, positive in (("deepseek-moe-16b", True), ("yi-6b", False)):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, seed=0, device="cpu")
        _, aux, (k, _) = decoder_layer_train(model.layers[0], x, pos, cfg)
        assert (float(aux) > 0) == positive, (arch, float(aux))
        assert tuple(k.shape) == (1, 16, cfg.num_kv_heads, cfg.head_dim)


def test_scripted_moe_serve_matches_reference():
    """``test_torch_serve.py``'s script on reduced deepseek-moe-16b: 3
    prompts of ragged length, a round, a fork of the first into 2, 5 more
    rounds.  Identical greedy tokens (every step's top-1 / top-2 margin
    above twice the logit tolerance), logits within 4e-3, <= 1 bulk launch
    per round on both engines, equal byte counters."""
    jmodel, params, tmodel, cfg = jax_and_port_models("deepseek-moe-16b")
    jeng = JServing(jmodel.cfg, params, max_seqs=8)
    teng = ServingEngine(cfg, tmodel, max_seqs=8, device="cpu")
    rng = np.random.default_rng(MOE_PROMPT_SEED)
    prompts = [rng.integers(2, 512, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    sids = [jeng.add_request(p.copy()) for p in prompts]
    assert [teng.add_request(p.copy()) for p in prompts] == sids
    for sid in sids:
        np.testing.assert_allclose(teng.last_logits[sid],
                                   jeng.last_logits[sid], atol=LOGIT_ATOL)
    for rnd in range(6):
        for sid, lg in jeng.last_logits.items():
            assert _margin(lg) > 2 * LOGIT_ATOL, (rnd, sid, _margin(lg))
        with _JaxHook() as ev_j, PortHook() as ev_t:
            if rnd == 1:
                assert jeng.fork(sids[0], 2) == teng.fork(sids[0], 2)
            toks_j = jeng.decode_round()
            toks_t = teng.decode_round()
        assert toks_t == toks_j, rnd
        mech_j = [m for _, _, m in ev_j]
        mech_t = [m for _, _, m in ev_t]
        assert len(mech_t) <= 1 and mech_t == mech_j, (rnd, mech_t, mech_j)
        for sid in toks_t:
            np.testing.assert_allclose(teng.last_logits[sid],
                                       jeng.last_logits[sid],
                                       atol=LOGIT_ATOL, err_msg=str(rnd))
    assert teng.tokens == jeng.tokens
    assert teng.pool_bytes_resident() == jeng.engine.pool_bytes_resident()
    assert teng.kv_bytes_live() == jeng.kv_bytes_live()
    assert teng.engine.stats.launches == jeng.engine.stats.launches == 2


def test_moe_init_params_is_seeded_and_scaled():
    """init_params draws the moe weights at the reference's scales (router
    0.02, expert and shared w_gate / w_up 1/sqrt(d), w_down 1/sqrt(f)) from
    the seed, and leaves a qkv_bias config's biases zero, as the
    reference's initialisers."""
    from repro_torch.weights import init_params
    cfg = get_config("deepseek-moe-16b").reduced()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    m = a.layers[1].moe
    assert torch.equal(m.w_down, b.layers[1].moe.w_down)
    f = cfg.moe_d_ff or cfg.d_ff
    for w, std in ((m.router, 0.02), (m.w_gate, cfg.d_model ** -0.5),
                   (m.w_up, cfg.d_model ** -0.5), (m.w_down, f ** -0.5),
                   (m.shared.w_gate, cfg.d_model ** -0.5),
                   (m.shared.w_down, (cfg.num_shared_experts * f) ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.1, (tuple(w.shape), std)
    assert not hasattr(a.layers[0], "w_gate")
    q = init_params(get_config("qwen2-72b").reduced(), seed=0, device="cpu")
    assert all(float(getattr(layer, n).abs().max()) == 0.0
               for layer in q.layers for n in ("bq", "bk", "bv"))
    assert float(q.layers[0].wq.abs().max()) > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-72b"])
def test_serve_cli_serves_the_new_configs(arch, capsys, monkeypatch):
    """The port's serving CLI takes a moe and the QKV-bias config by
    ``--arch`` and reports the reference CLI's RowClone stats; it refuses
    the families its engine does not serve."""
    import repro.launch.serve as jserve
    from repro_torch.launch import serve as tserve
    from test_torch_apps import _cli_stats
    args = ["--arch", arch, "--requests", "2", "--steps", "2", "--fork",
            "1", "--prompt-len", "64"]
    want = _cli_stats(jserve.main, ["serve", *args], capsys, monkeypatch)
    got = _cli_stats(tserve.main,
                     ["serve", "--smoke", "--device", "cpu", *args],
                     capsys, monkeypatch)
    assert got == want
    monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device", "cpu",
                                     "--arch", "mamba2-780m"])
    with pytest.raises(NotImplementedError):
        tserve.main()
