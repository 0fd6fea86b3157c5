"""The port's hybrid family (zamba2-2.7b reduced: 4 Mamba2 layers, the
shared attention+MLP block after every 2) against the JAX facade: prefill
through the Mamba2 layers and K3's plain version, greedy decode through
the Mamba2 decode step and K2's plain version over each segment's own pool
slab.  K2 and K3 at zamba2's head dim 80 are held against their plain
versions on the card in ``tests/test_torch_card.py``.

Tolerances as tests/test_torch_ssm.py: logits atol 2e-3, states and KV
pools atol 1e-4 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_contract import facade_parity, jax_and_port_models

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.weights import MAMBA2_PARAMS, init_params


@pytest.fixture(scope="module")
def hybrid():
    return jax_and_port_models("zamba2-2.7b")


@pytest.mark.parametrize("S", [40, 20])
def test_hybrid_facade_prefill_and_greedy_decode_match_reference(hybrid, S):
    """prefill_state then 4 greedy decode_state steps against the JAX
    facade: logits, greedy tokens, conv and ssm states and the per-segment
    K/V pools (S = 40 pads the SSD scan to 2 chunks, S = 20 is one ragged
    chunk)."""
    jmodel, params, tmodel, cfg = hybrid
    assert cfg.num_attn_layers == 2
    prompts = np.random.default_rng(S + 2).integers(
        2, cfg.vocab_size, (2, S)).astype(np.int32)
    facade_parity(jmodel, params, tmodel, cfg, prompts, logit_atol=2e-3,
                  state_atol=1e-4)


def test_hybrid_decode_across_a_page_boundary(hybrid):
    """A 62-token prompt (one page of margin by default): the decode steps
    cross from the first 64-token page into the second, a new block of each
    segment's slab."""
    jmodel, params, tmodel, cfg = hybrid
    prompts = np.random.default_rng(62).integers(
        2, cfg.vocab_size, (1, 62)).astype(np.int32)
    facade_parity(jmodel, params, tmodel, cfg, prompts, steps=4,
                  logit_atol=2e-3, state_atol=1e-4)


def test_hybrid_bf16_prefill_matches_reference():
    """The reduced hybrid in bf16: one facade prefill, logits and the
    segments' K/V pools (bf16, like the reference's) against JAX."""
    jmodel, params, tmodel, cfg = jax_and_port_models("zamba2-2.7b",
                                                      dtype="bfloat16")
    prompts = np.random.default_rng(9).integers(2, cfg.vocab_size, (2, 40))
    lj, sj = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)}, None)
    lt, st = tmodel.prefill_state(torch.from_numpy(prompts))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2)
    for key in ("k_pools", "v_pools"):
        assert st[key].dtype == torch.bfloat16
        want = np.asarray(sj[key], np.float32)
        # every segment reads bf16 activations of Mamba2 layers that may
        # differ by an ulp where two sums rounded differently: held at 2e-2
        # of the pools' scale (tests/test_torch_ssm.py checks the casts on
        # a first layer, where the inputs are equal)
        np.testing.assert_allclose(st[key].float().numpy(), want, rtol=0,
                                   atol=2e-2 * max(1.0,
                                                   float(np.abs(want).max())))


def test_make_serve_state_matches_reference(hybrid):
    jmodel, _, tmodel, _ = hybrid
    sj = jmodel.make_serve_state(3, 128, None, filled=5, dtype=jnp.float32)
    st = tmodel.make_serve_state(3, 128, filled=5)
    assert sorted(st) == sorted(sj)
    for key in sj:
        assert tuple(st[key].shape) == tuple(sj[key].shape), key
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


def test_from_jax_params_fills_every_hybrid_parameter(hybrid):
    """Every Mamba2 layer, the shared decoder layer and the untied head
    come from the JAX tree: shapes equal, values equal, nothing but norm
    gains and the conv bias left at zero."""
    jmodel, params, tmodel, cfg = hybrid
    for i, layer in enumerate(tmodel.layers):
        for name in MAMBA2_PARAMS:
            want = np.asarray(params["layers"][name][i])
            np.testing.assert_array_equal(getattr(layer, name).numpy(), want)
    sh = params["shared"]
    for name, want in (("ln1", sh["ln1"]), ("ln2", sh["ln2"]),
                       *((n, sh["attn"][n]) for n in ("wq", "wk", "wv",
                                                      "wo")),
                       *((n, sh["mlp"][n]) for n in ("w_gate", "w_up",
                                                     "w_down"))):
        got = getattr(tmodel.shared, name)
        assert tuple(got.shape) == np.asarray(want).shape, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if not name.startswith("ln"):
            assert float(got.abs().max()) > 0, name
    np.testing.assert_array_equal(tmodel.lm_head.numpy(),
                                  np.asarray(params["lm_head"]))
    assert float(tmodel.lm_head.abs().max()) > 0


def test_init_params_hybrid_is_seeded_and_complete():
    """init_params of the reduced hybrid is deterministic for a seed and
    fills the shared block and the untied head (scale 0.02)."""
    cfg = get_config("zamba2-2.7b").reduced()
    a = init_params(cfg, seed=5, device="cpu")
    b = init_params(cfg, seed=5, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    c = init_params(cfg, seed=6, device="cpu")
    assert not torch.equal(a.shared.wq, c.shared.wq)
    for name, p in a.named_parameters():
        if not any(k in name for k in ("norm", "ln", "conv_b")):
            assert float(p.abs().max()) > 0, name
    assert abs(float(a.lm_head.std()) - 0.02) < 2e-3
    assert abs(float(a.shared.w_down.std()) - cfg.d_ff ** -0.5) < 5e-3


def test_serving_engine_and_dense_entries_refuse_the_hybrid(hybrid):
    """The serving engine admits a hybrid prompt (its conv / ssm state in
    ``_extras``) but refuses its decode round with the reference's
    message (tests/test_torch_encdec.py holds the admission against the
    JAX engine); the dense-only prefill / decode_step pair raises for the
    hybrid, which decodes through decode_state."""
    from repro_torch.launch.serve import DECODE_REFUSAL, ServingEngine
    _, _, tmodel, cfg = hybrid
    eng = ServingEngine(cfg, tmodel, max_seqs=2, max_blocks_per_seq=4,
                        device="cpu")
    sid = eng.add_request(np.arange(2, 12, dtype=np.int32))
    assert sorted(eng._extras[sid]) == ["conv_state", "ssm_state"]
    with pytest.raises(NotImplementedError) as err:
        eng.decode_round()
    assert str(err.value) == DECODE_REFUSAL
    eng.free(sid)
    assert eng._extras == {}
    with pytest.raises(NotImplementedError):
        tmodel.prefill(torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("wrapper", ["paged_attention", "flash_attention"])
def test_head_dim_80_accepted_and_others_refused_before_launch(wrapper):
    """The K2 / K3 wrappers take head dims 80 and 128 and refuse any other
    (96) before touching the card (CPU tensors are refused too)."""
    from repro_torch.kernels import flash_attention, paged_attention
    assert 80 in paged_attention.HEAD_DIMS and 128 in paged_attention.HEAD_DIMS
    assert flash_attention.HEAD_DIMS == paged_attention.HEAD_DIMS
    for D in (96, 80):
        if wrapper == "paged_attention":
            q = torch.zeros((2, 4, D), dtype=torch.bfloat16)
            kv = torch.zeros((3, 16, 4, D), dtype=torch.bfloat16)
            call = lambda: paged_attention.paged_attention_slab_cuda(  # noqa
                q, kv, kv, torch.ones((3, 2), dtype=torch.int8),
                torch.zeros(3, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32), page=16)
        else:
            q = torch.zeros((1, 4, 8, D), dtype=torch.bfloat16)
            call = lambda: flash_attention.flash_attention_cuda(q, q, q)  # noqa
        with pytest.raises(ValueError) as err:
            call()
        assert ("head dim" in str(err.value)) == (D == 96)
