"""The port's encdec family (seamless-m4t-medium reduced: 2 encoder and 4
decoder layers, 4 heads over 4 KV heads x 32) against the JAX package: the
encoder stack (non-causal K3 plain version, RoPE over the frames), the
cross-attention block (Sq != Skv), prefill and greedy decode through the
facade (K2's plain version over the decoder's pools, K3's over the cross
K/V at one query), the weights, and the serving engine's admission of the
hybrid and encdec families (the reference admits them and refuses only
their decode rounds).  K2 and K3 at seamless's head dim 64 are held against
their plain versions on the card in ``tests/test_torch_card.py``.

Tolerances as tests/test_torch_vlm.py: logits atol 4e-3 (both heads are
bf16 products), K/V pools and cross K/V atol 1e-4 in fp32 (another
summation order); the bf16 model's logits 2e-2 and states 2e-2 of their
scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import (PortHook, bits, common_stats, facade_parity,
                                 jax_and_port_models, journal_rows)
from test_torch_serve import _JaxHook

import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.models import build_model, split_params
from repro.models import transformer as jtfm
from repro.models.attention import MaskInfo
from repro.models.common import rms_norm as jrms_norm
from repro_torch.configs import get_config
from repro_torch.launch.serve import (DECODE_REFUSAL, EXTRA_KEYS,
                                      ServingEngine)
from repro_torch.models import transformer as ttfm
from repro_torch.weights import SWIGLU_PARAMS, from_jax_params, init_params

LOGIT_ATOL, KV_ATOL = 4e-3, 1e-4
BF16_REL = 2e-2


def frames_for(cfg, B: int, S: int, seed: int) -> np.ndarray:
    """Source frames of a prompt of S tokens, as the reference's input
    specs size them (S // src_frames_ratio), N(0, 1) x 0.02 from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    n = max(S // cfg.src_frames_ratio, 1)
    return (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(
        np.float32)


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_to_scale(got: torch.Tensor, want, rel: float = BF16_REL,
                    what: str = "") -> None:
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def encdec():
    return jax_and_port_models("seamless-m4t-medium")


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 46, 62])
def test_encdec_facade_prefill_and_greedy_decode_match_reference(encdec, S):
    """prefill_state over S tokens and S // 4 source frames, then 4 greedy
    decode_state steps, against the JAX facade: logits, greedy tokens, the
    decoder's K/V pools and the cross K/V (S = 62: the steps cross from the
    first 64-token page into the second)."""
    jmodel, params, tmodel, cfg = encdec
    assert (cfg.encoder_layers, cfg.num_layers, cfg.num_attn_layers) == \
        (2, 4, 4)
    facade_parity(jmodel, params, tmodel, cfg, _prompts(cfg, 2, S, S),
                  logit_atol=LOGIT_ATOL, state_atol=KV_ATOL,
                  src=frames_for(cfg, 2, S, S + 1))


@pytest.mark.parametrize("S", [40, 62])
def test_encdec_bf16_prefill_and_decode_match_reference(S):
    """The reduced encdec in bf16: prefill and 4 decode steps, each fed the
    reference's greedy token; logits at 2e-2 every call, and the K/V pools
    and cross K/V (bf16, like the reference's) at 2e-2 of their scale after
    the prefill and after the last step."""
    jmodel, params, tmodel, cfg = jax_and_port_models(
        "seamless-m4t-medium", dtype="bfloat16")
    prompts, src = _prompts(cfg, 2, S, 9), frames_for(cfg, 2, S, 10)
    lj, sj = jmodel.prefill(params, {"tokens": jnp.asarray(prompts),
                                     "src_embeds": jnp.asarray(src)}, None)
    lt, st = tmodel.prefill_state(torch.from_numpy(prompts).long(),
                                  src_embeds=torch.from_numpy(src))
    for step in range(5):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2,
                                   err_msg=f"call {step}")
        if step in (0, 4):
            for key in ("k_pools", "v_pools", "cross_k", "cross_v"):
                assert st[key].dtype == torch.bfloat16, key
                _close_to_scale(st[key], sj[key], what=f"{key} {step}")
        if step == 4:
            break
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)
        lj, sj = jmodel.decode_step(params, sj, jnp.asarray(tok), None)
        lt, st = tmodel.decode_state(st, torch.from_numpy(tok.copy()).long())


def test_encoder_stack_and_cross_block_match_reference(encdec):
    """The encoder (both layers non-causal with RoPE over the frames, then
    enc_norm) against the JAX decoder_stack_train over ``enc_layers``, and
    decoder layer 0's cross_block_train (text of 24 over 6 frames: Sq !=
    Skv) against the JAX function: outputs and the cross K/V."""
    jmodel, params, tmodel, cfg = encdec
    src = frames_for(cfg, 2, 24, 3)
    pos = jnp.broadcast_to(jnp.arange(src.shape[1]), src.shape[:2])
    enc_j, _, _, _ = jtfm.decoder_stack_train(
        params["enc_layers"], jnp.asarray(src), pos, jmodel.cfg, None,
        MaskInfo(causal=False), remat="none")
    enc_j = jrms_norm(enc_j, params["enc_norm"], cfg.norm_eps)
    enc_t = tmodel._encode(torch.from_numpy(src))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=KV_ATOL,
                               rtol=1e-4)
    x = (np.random.default_rng(4).standard_normal((2, 24, cfg.d_model))
         ).astype(np.float32)
    xj, (kj, vj) = jtfm.cross_block_train(
        _layer(params["layers"], 0), jnp.asarray(x), enc_j, jmodel.cfg, None,
        return_kv=True)
    xt, (kt, vt) = ttfm.cross_block_train(tmodel.layers[0],
                                          torch.from_numpy(x), enc_t, cfg)
    assert tuple(kt.shape) == (2, 6, cfg.num_kv_heads, cfg.head_dim)
    for got, want in ((xt, xj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KV_ATOL, rtol=1e-4)
    # the cross block sees every frame: changing the last frame moves the
    # first text position's output
    src2 = src.copy()
    src2[:, -1] += 1.0
    x2, _ = ttfm.cross_block_train(tmodel.layers[0], torch.from_numpy(x),
                                   tmodel._encode(torch.from_numpy(src2)),
                                   cfg)
    assert float((x2[:, 0] - xt[:, 0]).abs().max()) > 0


def test_decode_cross_path_matches_reference(encdec):
    """One decoder layer's decode step with cross K/V (one query over 10
    frames) against the JAX decoder_layer_decode(cross_kv=): the output,
    and the appended K/V slab."""
    jmodel, params, tmodel, cfg = encdec
    rng = np.random.default_rng(7)
    B, page, nblk, S_src = 2, 64, 4, 10
    KVH, D = cfg.num_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 70], np.int32)
    kp = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    table = np.array([[0, 1], [2, 3]], np.int32)
    mask = np.zeros((nblk, B), np.int8)
    mask[[0, 1], 0] = 1
    mask[[2, 3], 1] = 1
    base = np.array([0, 64, 0, 64], np.int32)
    xk = rng.standard_normal((B, S_src, KVH, D)).astype(np.float32)
    xv = rng.standard_normal((B, S_src, KVH, D)).astype(np.float32)
    ids = table[np.arange(B), pos // page]
    xj, (kj, vj), _ = jtfm.decoder_layer_decode(
        _layer(params["layers"], 1), jnp.asarray(x), jnp.asarray(pos),
        (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(ids),
        jnp.asarray(pos % page), jnp.asarray(mask), jnp.asarray(base),
        jnp.asarray(pos + 1), jmodel.cfg, None,
        cross_kv=(jnp.asarray(xk), jnp.asarray(xv)))
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    post = torch.from_numpy(pos).long()
    appends = [(torch.arange(B), torch.from_numpy(ids).long(), post % page)]
    xt = ttfm.decoder_layer_decode(
        tmodel.layers[1], torch.from_numpy(x), post, [kt], [vt], appends,
        torch.from_numpy(mask), torch.from_numpy(base),
        torch.from_numpy(pos + 1), cfg, page,
        cross_kv=(torch.from_numpy(xk), torch.from_numpy(xv)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=KV_ATOL,
                               rtol=1e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=KV_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=KV_ATOL)
    # without the cross K/V the layer is another function
    xt0 = ttfm.decoder_layer_decode(
        tmodel.layers[1], torch.from_numpy(x), post, [kt.clone()],
        [vt.clone()], appends, torch.from_numpy(mask), torch.from_numpy(base),
        torch.from_numpy(pos + 1), cfg, page)
    assert float((xt0 - xt).abs().max()) > 1e-3


def test_make_serve_state_matches_reference(encdec):
    """make_serve_state's keys, shapes and zeros: cross K/V of
    max(seq_len // 4, 1) frames, also for a seq_len below the ratio."""
    jmodel, _, tmodel, _ = encdec
    for seq_len in (128, 3):
        sj = jmodel.make_serve_state(3, seq_len, None, filled=1,
                                     dtype=jnp.float32)
        st = tmodel.make_serve_state(3, seq_len, filled=1)
        assert sorted(st) == sorted(sj)
        for key in sj:
            assert tuple(st[key].shape) == tuple(sj[key].shape), key
            np.testing.assert_array_equal(st[key].numpy(),
                                          np.asarray(sj[key]))


def test_encdec_prefill_needs_its_frames(encdec):
    """src_embeds are required for encdec and refused for every other
    family (patch_embeds likewise for vlm); the seq_lens count the text
    only and the cross K/V take the frames' length."""
    _, _, tmodel, cfg = encdec
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="src_embeds"):
        tmodel.prefill_state(tokens)
    with pytest.raises(ValueError, match="patch_embeds"):
        tmodel.prefill_state(tokens, torch.zeros((1, 16, cfg.d_model)),
                             src_embeds=torch.zeros((1, 1, cfg.d_model)))
    _, st = tmodel.prefill_state(tokens,
                                 src_embeds=torch.zeros((1, 3, cfg.d_model)))
    assert int(st["seq_lens"][0]) == 4
    assert tuple(st["cross_k"].shape) == (4, 1, 3, 4, 32)
    for arch in ("zamba2-2.7b", "llama3.2-3b"):
        other = init_params(get_config(arch).reduced(), 0, "cpu")
        with pytest.raises((ValueError, NotImplementedError)):
            other.prefill_state(tokens, src_embeds=torch.zeros((1, 1, 128)))
    with pytest.raises(NotImplementedError):
        tmodel.prefill(tokens)


def test_from_jax_params_fills_every_encdec_parameter(encdec):
    """Every encoder layer, decoder layer (with its cross-attention), the
    norms and the untied head come from the JAX tree: shapes and values
    equal, nothing but the norm gains left at zero."""
    _, params, tmodel, cfg = encdec
    attn = ("wq", "wk", "wv", "wo")
    for mods, tree in ((tmodel.layers, params["layers"]),
                       (tmodel.enc_layers, params["enc_layers"])):
        for i, layer in enumerate(mods):
            pairs = [("ln1", tree["ln1"]), ("ln2", tree["ln2"])] + \
                [(n, tree["attn"][n]) for n in attn] + \
                [(n, tree["mlp"][n]) for n in SWIGLU_PARAMS]
            for name, want in pairs:
                got = getattr(layer, name)
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(want[i]))
                if not name.startswith("ln"):
                    assert float(got.abs().max()) > 0, name
            if mods is tmodel.enc_layers:
                assert not hasattr(layer, "xattn")
                continue
            np.testing.assert_array_equal(layer.ln_x.numpy(),
                                          np.asarray(tree["ln_x"][i]))
            for n in attn:
                got = getattr(layer.xattn, n)
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(tree["xattn"][n][i]))
                assert float(got.abs().max()) > 0, n
    np.testing.assert_array_equal(tmodel.enc_norm.numpy(),
                                  np.asarray(params["enc_norm"]))
    np.testing.assert_array_equal(tmodel.lm_head.numpy(),
                                  np.asarray(params["lm_head"]))


def test_init_params_encdec_is_seeded_and_complete():
    """init_params of the reduced encdec is deterministic for a seed, draws
    the reference's scales (cross-attention as a self-attention's
    projections) and allocates ``param_count()`` plus the final and the
    encoder norms."""
    cfg = get_config("seamless-m4t-medium").reduced()
    a = init_params(cfg, seed=5, device="cpu")
    b = init_params(cfg, seed=5, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    c = init_params(cfg, seed=6, device="cpu")
    assert not torch.equal(a.layers[0].xattn.wq, c.layers[0].xattn.wq)
    for name, p in a.named_parameters():
        if not any(k in name for k in ("norm", "ln")):
            assert float(p.abs().max()) > 0, name
    assert abs(float(a.lm_head.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].xattn.wq.std()) - cfg.d_model ** -0.5) < \
        5e-3
    assert abs(float(a.enc_layers[1].w_down.std()) - cfg.d_ff ** -0.5) < 5e-3
    assert sum(p.numel() for p in a.parameters()) == \
        cfg.param_count() + 2 * cfg.d_model


# ---------------------------------------------------------------------------
# ServingEngine admission of the hybrid and encdec families
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_seqs=4, max_blocks_per_seq=8, num_slabs=2,
                 spill_pages=8)
#: prompts of the admission script: one page, and two pages (a ragged
#: second)
ADMIT_LENS = (8, 100)


@pytest.fixture(params=["zamba2-2.7b",
                                        "seamless-m4t-medium"])
def admitted(request):
    """The JAX and the port's engines on the same reduced weights, each
    after admitting :data:`ADMIT_LENS` (the port's launch events of the
    admissions recorded)."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    params, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config(arch).reduced()
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             cfg, device="cpu")
    jeng = jserve.ServingEngine(jcfg, params, **ENGINE_KW)
    teng = ServingEngine(cfg, tmodel, device="cpu", **ENGINE_KW)
    prompts = [np.random.default_rng(30 + i).integers(
        2, cfg.vocab_size, n).astype(np.int32)
        for i, n in enumerate(ADMIT_LENS)]
    for eng in (jeng, teng):
        assert [eng.add_request(p.copy()) for p in prompts] == [0, 1]
    return cfg, jeng, teng, prompts


def _extras_close(jeng, teng, sid):
    assert sorted(teng._extras[sid]) == sorted(jeng._extras[sid])
    for key, want in jeng._extras[sid].items():
        got = teng._extras[sid][key]
        assert tuple(got.shape) == tuple(np.asarray(want).shape), key
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KV_ATOL, rtol=1e-4, err_msg=key)


def _flush(eng, hook):
    """Drain the serve stream as a round would (decode_round refuses these
    families) and close the round's books."""
    with hook as events:
        eng.stream.flush()
    eng._post_flush()
    return [m for _, _, m in events]


def test_engine_admits_hybrid_and_encdec_like_reference(admitted):
    """Admission through the facade's prefill with no decode margin (an
    encdec over zero source frames): the staged pages equal the JAX
    engine's, ``_extras`` holds the same keys, shapes and values (the
    hybrid's conv / ssm state, the encdec's cross K/V of S // 4 frames),
    the promotions drain in one launch whose table and stats equal the
    reference's, and the promoted blocks equal the staged pages bitwise;
    the staged pages also equal the facade's prefill on the same prompt
    (an encdec's with zero frames)."""
    cfg, jeng, teng, prompts = admitted
    want_extras = {"hybrid": ("conv_state", "ssm_state"),
                   "encdec": ("cross_k", "cross_v")}[cfg.family]
    for sid, prompt in enumerate(prompts):
        assert tuple(sorted(teng._extras[sid])) == want_extras
        assert set(want_extras) <= set(EXTRA_KEYS)
        _extras_close(jeng, teng, sid)
    if cfg.family == "encdec":
        assert tuple(teng._extras[1]["cross_k"].shape) == \
            (4, 1, 25, 4, 32)
    for name in ("k_stage", "v_stage"):
        np.testing.assert_allclose(teng.engine.pools[name].numpy(),
                                   np.asarray(jeng.engine.pools[name]),
                                   atol=KV_ATOL, rtol=1e-4, err_msg=name)
    staged = {n: teng.engine.pools[n + "_stage"].clone() for n in ("k", "v")}
    pairs = [p for sid in (0, 1) for p in teng._pending_promotions[sid]]
    assert pairs == [p for sid in (0, 1)
                     for p in jeng._pending_promotions[sid]]
    assert len(pairs) == 3
    mech_j = _flush(jeng, _JaxHook())
    mech_t = _flush(teng, PortHook())
    assert mech_t == mech_j == ["fused"]
    assert journal_rows(teng.engine) == journal_rows(jeng.engine)
    stats_j, stats_t = common_stats(jeng.engine, teng.engine)
    assert stats_t == stats_j
    for n in ("k", "v"):
        for s, d in pairs:
            np.testing.assert_array_equal(
                bits(teng.engine.pools[n][:, d]), bits(staged[n][:, s]))
    # the staged pages are the facade's prefill of the same prompt
    model = teng.model
    for sid, prompt in enumerate(prompts):
        extra = {}
        if cfg.family == "encdec":
            extra["src_embeds"] = torch.zeros(
                (1, max(len(prompt) // 4, 1), cfg.d_model))
        _, st = model.prefill_state(torch.from_numpy(prompt)[None].long(),
                                    margin_tokens=0, **extra)
        blocks = teng.cache.blocks_of(sid)
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                bits(teng.engine.pools[n][:, blocks]), bits(st[n + "_pools"]))


def test_engine_extras_follow_fork_demote_resume_free(admitted):
    """A fork shares the parent's extras; demote parks them with the
    sequence and resume restores them under the new sid; free drops them;
    decode_round raises the reference's refusal; and after every sequence
    is freed the allocator and ``_extras`` are back where they started.
    Tables, stats and spill slots equal the JAX engine's."""
    cfg, jeng, teng, _ = admitted
    free0 = teng.engine.alloc.total_free() + sum(
        len(teng.cache.blocks_of(s)) for s in teng.cache.seqs)
    for eng in (jeng, teng):
        with pytest.raises(NotImplementedError) as err:
            eng.decode_round()
        assert str(err.value) == DECODE_REFUSAL
    if teng._staged_sids:
        _flush(jeng, _JaxHook())
        _flush(teng, PortHook())
    kids_j, kids_t = jeng.fork(1, 1), teng.fork(1, 1)
    assert kids_t == kids_j == [2]
    assert teng._extras[2] is teng._extras[1]
    held = dict(teng._extras[1])
    for eng in (jeng, teng):
        eng.demote(1)
    assert 1 not in teng._extras and teng.demoted[1].extras is not None
    assert teng.demoted[1].slots == jeng.demoted[1].slots
    assert _flush(teng, PortHook()) == _flush(jeng, _JaxHook()) == ["fused"]
    assert jeng.resume(1) == teng.resume(1) == 3
    for key, t in held.items():
        assert teng._extras[3][key] is t
    _extras_close(jeng, teng, 3)
    assert _flush(teng, PortHook()) == _flush(jeng, _JaxHook()) == ["fused"]
    assert journal_rows(teng.engine) == journal_rows(jeng.engine)
    stats_j, stats_t = common_stats(jeng.engine, teng.engine)
    assert stats_t == stats_j
    assert teng.engine.spill_slots_free == jeng.engine.spill_slots_free == 8
    for eng in (jeng, teng):
        for sid in sorted(eng.cache.seqs):
            eng.free(sid)
        assert eng._extras == {} and eng.cache.seqs == {}
    assert teng.engine.alloc.total_free() == free0 == \
        jeng.engine.alloc.total_free()


def test_engine_still_refuses_vlm_and_ssm():
    """vlm stays refused (the reference's admission drops its patch
    positions) and ssm has no KV pages to stage."""
    for arch, match in (("paligemma-3b", "patch positions"),
                        ("mamba2-780m", "no KV pages")):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, 0, "cpu")
        with pytest.raises(NotImplementedError, match=match):
            ServingEngine(cfg, model, device="cpu")


def test_admission_legacy_leg_matches_fused_leg(admitted):
    """``fused_staging=False`` writes the same pages straight into the K/V
    pools: bitwise equal to the fused leg's promoted blocks, with the same
    extras."""
    cfg, _, teng, prompts = admitted
    legacy = ServingEngine(cfg, teng.model, device="cpu",
                           fused_staging=False, **ENGINE_KW)
    fused = ServingEngine(cfg, teng.model, device="cpu", **ENGINE_KW)
    for eng in (legacy, fused):
        for p in prompts:
            eng.add_request(p.copy())
    _flush(fused, PortHook())
    for sid in (0, 1):
        assert legacy.cache.blocks_of(sid) == fused.cache.blocks_of(sid)
        blocks = fused.cache.blocks_of(sid)
        for n in ("k", "v"):
            assert torch.equal(legacy.engine.pools[n][:, blocks],
                               fused.engine.pools[n][:, blocks])
        for key, t in fused._extras[sid].items():
            assert torch.equal(legacy._extras[sid][key], t)


def test_reference_admission_dataclass_fields_match():
    """The port's DemotedSeq carries the reference's fields, extras
    included."""
    from repro_torch.launch.serve import DemotedSeq
    assert [f.name for f in dataclasses.fields(DemotedSeq)] == \
        [f.name for f in dataclasses.fields(jserve.DemotedSeq)]
