"""The port's vlm family (paligemma-3b reduced: 4 decoder layers, 4 heads
over 1 KV head x 32, 16 patch embeddings) against the JAX facade: prefill
over the patch prefix (prefix-LM mask, K3's plain version) and greedy
decode over the paged pools (K2's plain version).  K2 and K3 at
paligemma's head dim 256 are held against their plain versions on the card
in ``tests/test_torch_card.py``.

Tolerances as tests/test_torch_model.py: logits atol 4e-3 (both heads are
bf16 products), KV pools atol 1e-4 in fp32 (another summation order); the
bf16 model's logits 2e-2 and pools 2e-2 of their scale, as the hybrid's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_contract import facade_parity, jax_and_port_models

from repro_torch.configs import get_config
from repro_torch.weights import SWIGLU_PARAMS, init_params

LOGIT_ATOL, KV_ATOL = 4e-3, 1e-4


def patches_for(cfg, B: int, seed: int) -> np.ndarray:
    """Patch embeddings as tests/test_models.py draws them: N(0, 1) x 0.02,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
            * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def vlm():
    return jax_and_port_models("paligemma-3b")


@pytest.mark.parametrize("S", [40, 46])
def test_vlm_facade_prefill_and_greedy_decode_match_reference(vlm, S):
    """prefill_state over 16 patches + S tokens, then 4 greedy
    decode_state steps, against the JAX facade: logits, greedy tokens and
    the K/V pools (S = 46: 62 positions, so the steps cross from the first
    64-token page into the second)."""
    jmodel, params, tmodel, cfg = vlm
    assert cfg.vision_tokens == 16 and cfg.num_attn_layers == 4
    prompts = np.random.default_rng(S).integers(
        2, cfg.vocab_size, (2, S)).astype(np.int32)
    facade_parity(jmodel, params, tmodel, cfg, prompts,
                  logit_atol=LOGIT_ATOL, state_atol=KV_ATOL,
                  patches=patches_for(cfg, 2, S + 1))


def test_vlm_bf16_prefill_and_decode_match_reference():
    """The reduced vlm in bf16: one facade prefill and one decode step,
    logits and the K/V pools (bf16, like the reference's) against JAX."""
    jmodel, params, tmodel, cfg = jax_and_port_models("paligemma-3b",
                                                      dtype="bfloat16")
    prompts = np.random.default_rng(9).integers(2, cfg.vocab_size, (2, 40))
    patches = patches_for(cfg, 2, 10)
    lj, sj = jmodel.prefill(params, {"tokens": jnp.asarray(prompts),
                                     "patch_embeds": jnp.asarray(patches)},
                            None)
    lt, st = tmodel.prefill_state(torch.from_numpy(prompts),
                                  torch.from_numpy(patches))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)
    lj, sj = jmodel.decode_step(params, sj, jnp.asarray(tok), None)
    lt, st = tmodel.decode_state(st, torch.from_numpy(tok.copy()).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2)
    for key in ("k_pools", "v_pools"):
        assert st[key].dtype == torch.bfloat16
        want = np.asarray(sj[key], np.float32)
        np.testing.assert_allclose(st[key].float().numpy(), want, rtol=0,
                                   atol=2e-2 * max(1.0,
                                                   float(np.abs(want).max())))


def test_vlm_prefix_is_bidirectional_and_text_causal(vlm):
    """The port's own check of the prefix-LM mask: changing the LAST patch
    moves layer 1's K at position 0 (the first patch attended to it in
    layer 0), while changing the last text token leaves every earlier
    position's K/V in every layer as it was."""
    _, _, tmodel, cfg = vlm
    P = cfg.vision_tokens
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab_size, (1, 24)))
    patches = torch.from_numpy(patches_for(cfg, 1, 5))
    _, st = tmodel.prefill_state(tokens, patches)
    moved = patches.clone()
    moved[:, -1] += 1.0
    _, st2 = tmodel.prefill_state(tokens, moved)
    assert float((st["k_pools"][1, 0, 0] - st2["k_pools"][1, 0, 0])
                 .abs().max()) > 0, "the patch prefix is not bidirectional"
    text = tokens.clone()
    text[:, -1] = (text[:, -1] + 1) % cfg.vocab_size
    _, st3 = tmodel.prefill_state(text, patches)
    S = P + tokens.shape[1]
    for key in ("k_pools", "v_pools"):
        torch.testing.assert_close(st3[key][:, 0, :S - 1],
                                   st[key][:, 0, :S - 1], atol=0, rtol=0)
        assert not torch.equal(st3[key][:, 0, S - 1], st[key][:, 0, S - 1])


def test_vlm_prefill_needs_its_patches(vlm):
    """patch_embeds are required for vlm and refused for other families;
    the seq_lens count the patch positions."""
    _, _, tmodel, cfg = vlm
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError):
        tmodel.prefill_state(tokens)
    _, st = tmodel.prefill_state(tokens,
                                 torch.zeros((1, cfg.vision_tokens,
                                              cfg.d_model)))
    assert int(st["seq_lens"][0]) == cfg.vision_tokens + 4
    ssm = init_params(get_config("mamba2-780m").reduced(), 0, "cpu")
    with pytest.raises(ValueError):
        ssm.prefill_state(tokens, torch.zeros((1, 16, 128)))


def test_from_jax_params_fills_every_vlm_parameter(vlm):
    """Every decoder layer and the tied embedding come from the JAX tree:
    shapes and values equal, the head tied (no ``lm_head``), nothing but
    the norm gains left at zero."""
    _, params, tmodel, cfg = vlm
    assert cfg.tie_embeddings and not hasattr(tmodel, "lm_head")
    np.testing.assert_array_equal(tmodel.embed.numpy(),
                                  np.asarray(params["embed"]))
    lay = params["layers"]
    for i, layer in enumerate(tmodel.layers):
        for name, want in (("ln1", lay["ln1"]), ("ln2", lay["ln2"]),
                           *((n, lay["attn"][n]) for n in ("wq", "wk", "wv",
                                                           "wo")),
                           *((n, lay["mlp"][n]) for n in SWIGLU_PARAMS)):
            got = getattr(layer, name)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))
            if not name.startswith("ln"):
                assert float(got.abs().max()) > 0, name


def test_init_params_vlm_is_seeded_and_complete():
    """init_params of the reduced vlm is deterministic for a seed, ties
    the head and draws the reference's scales; its parameter count is
    ``param_count()`` plus the final norm."""
    cfg = get_config("paligemma-3b").reduced()
    a = init_params(cfg, seed=5, device="cpu")
    b = init_params(cfg, seed=5, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert not torch.equal(a.layers[0].wq,
                           init_params(cfg, seed=6, device="cpu").layers[0].wq)
    assert not hasattr(a, "lm_head")
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].w_down.std()) - cfg.d_ff ** -0.5) < 5e-3
    assert sum(p.numel() for p in a.parameters()) == \
        cfg.param_count() + cfg.d_model


def test_engine_and_cli_refuse_the_vlm(vlm, monkeypatch):
    """The serving engine and the serve CLI refuse paligemma: the
    reference's admission drops the patch positions its prefill writes.
    The engine's pair (prefill / decode_step) refuses it too."""
    from repro_torch.launch import serve as tserve
    _, _, tmodel, cfg = vlm
    with pytest.raises(NotImplementedError) as err:
        tserve.ServingEngine(cfg, tmodel, device="cpu")
    assert "patch positions" in str(err.value)
    assert "prefill_state / decode_state" in str(err.value)
    with pytest.raises(NotImplementedError):
        tmodel.prefill(torch.zeros((1, 4), dtype=torch.long))
    monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device", "cpu",
                                     "--arch", "paligemma-3b"])
    with pytest.raises(NotImplementedError) as err:
        tserve.main()
    assert "patch positions" in str(err.value)
