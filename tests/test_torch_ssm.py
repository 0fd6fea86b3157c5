"""The port's Mamba2 / SSD path (ssm family, mamba2-780m reduced) against
the JAX package: the plain version of K4 against the JAX oracle and the
Pallas kernel in interpret mode, the chunked scan against the JAX scan and
the naive recurrence, the conv, the layer and its decode step, and the
whole model's prefill and greedy decode through the facade.

Tolerances: fp32 atol 1e-4 (summation order only), as
``tests/test_kernels.py``; the chunked scan atol 2e-3 / rtol 1e-3, as
``test_kernels.py``'s scan-vs-recurrence check; logits atol 2e-3, the bound
of ``tests/test_models.py``'s decode check (both heads are bf16 products,
so a logit may differ by one bf16 ulp of the reduced model's |logit| <
0.5); bf16 activations 2e-2, as the dense bf16 tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import facade_parity, jax_and_port_models, to_torch

from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_intra_chunk_pallas
from repro.models import mamba2 as jm2
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_chunk import HEADS_PER_CTA
from repro_torch.models import mamba2 as tm2
from repro_torch.weights import MAMBA2_PARAMS, init_params

F32_ATOL = 1e-4


def _chunk_case(seed, B, Q, H, P, N):
    """Intra-chunk inputs as the test of the JAX kernel makes them: dt
    softplus'd, ``cum`` an in-chunk cumsum of ``-0.2 dt`` (so <= 0 and
    decreasing)."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, Q, H, P)).astype(np.float32)
    dtb = np.log1p(np.exp(rng.standard_normal((B, Q, H)))).astype(np.float32)
    cum = np.cumsum(-0.2 * dtb, axis=1).astype(np.float32)
    Bm = rng.standard_normal((B, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((B, Q, N)).astype(np.float32)
    return xb, dtb, cum, Bm, Cm


@pytest.mark.parametrize("Q,P,N", [(32, 16, 8), (64, 32, 16), (24, 16, 8)])
def test_ssd_intra_chunk_matches_oracle_and_pallas(Q, P, N):
    args = _chunk_case(Q + N, 2, Q, 4, P, N)
    got = ops.ssd_intra_chunk(*(to_torch(a) for a in args))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, Q, 4, P)
    want = jm2._ssd_intra_chunk_jnp(*(jnp.asarray(a) for a in args))
    want_pl = ssd_intra_chunk_pallas(*(jnp.asarray(a) for a in args),
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pl),
                               atol=F32_ATOL)


def test_ssd_intra_chunk_never_forms_inf_above_the_diagonal():
    """A steep decay makes ``cum_i - cum_j`` large and positive above the
    diagonal, where exp overflows; the term selects there, so the output
    stays finite and equals the oracle."""
    xb, dtb, _, Bm, Cm = _chunk_case(9, 1, 32, 2, 16, 8)
    cum = np.cumsum(-40.0 * dtb, axis=1).astype(np.float32)
    got = ops.ssd_intra_chunk(*(to_torch(a) for a in (xb, dtb, cum, Bm,
                                                      Cm)))
    assert torch.isfinite(got).all()
    want = jm2._ssd_intra_chunk_jnp(*(jnp.asarray(a) for a in
                                      (xb, dtb, cum, Bm, Cm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


#: chip_smoke.py's K4 limit: max |diff| <= K4_RTOL x max |oracle|
K4_RTOL = 1e-3


def _bf16(a):
    """The float32 values of ``a`` rounded to bf16 (the models' x / B / C)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _k4_tensor_core_emulation(xb, dtb, cum, Bb, Cb, *, parts=3, tile=64):
    """K4's bf16 path in plain torch: for each (i-tile, j-tile up to the
    diagonal) the scores ``C_i B_j^T`` once per group of HEADS_PER_CTA heads,
    then per head ``W = S exp(cum_i - cum_j) dt_j`` where j <= i, fed to
    ``W x_j`` as ``parts`` bf16 parts (each the bf16 of what the earlier
    ones leave out), each product summed in fp32."""
    B, Q, H, P = xb.shape
    y = torch.zeros((B, Q, H, P))
    for i0 in range(0, Q, tile):
        i1 = min(i0 + tile, Q)
        rows = torch.arange(i0, i1)[:, None]
        for j0 in range(0, i1, tile):
            j1 = min(j0 + tile, Q)
            low = torch.arange(j0, j1)[None, :] <= rows
            for h0 in range(0, H, HEADS_PER_CTA):
                S = Cb[:, i0:i1] @ Bb[:, j0:j1].transpose(1, 2)
                for h in range(h0, min(h0 + HEADS_PER_CTA, H)):
                    seg = cum[:, i0:i1, None, h] - cum[:, None, j0:j1, h]
                    W = torch.where(low, S * torch.exp(seg), 0.0) * \
                        dtb[:, None, j0:j1, h]
                    x = xb[:, j0:j1, h]
                    for _ in range(parts):
                        part = W.bfloat16().float()
                        y[:, i0:i1, h] += part @ x
                        W = W - part
    return y


@pytest.mark.parametrize("Q,H,N", [(256, 6, 128), (250, 5, 64)])
def test_ssd_intra_chunk_tensor_core_numerics_match_oracle(Q, H, N):
    """The kernel's bf16 arithmetic (scores shared by a group of heads, W in
    three bf16 parts) against the JAX oracle at a full chunk (Q = 256, N =
    128) and a ragged one (Q = 250, a partial head group): within K4_RTOL x
    max, and far closer than W as one or two bf16 parts."""
    xb, dtb, cum, Bm, Cm = _chunk_case(Q + N, 2, Q, H, 64, N)
    xb, Bm, Cm = _bf16(xb), _bf16(Bm), _bf16(Cm)
    want = np.asarray(jm2._ssd_intra_chunk_jnp(
        *(jnp.asarray(a) for a in (xb, dtb, cum, Bm, Cm))))
    args = [to_torch(a) for a in (xb, dtb, cum, Bm, Cm)]
    scale = float(np.abs(want).max())
    err = [float(np.abs(_k4_tensor_core_emulation(*args, parts=n).numpy()
                        - want).max()) for n in (3, 2, 1)]
    assert err[0] <= K4_RTOL * scale
    assert err[0] * 20 < err[1] and err[1] * 20 < err[2]


def _k4_fp32_emulation(xb, dtb, cum, Bb, Cb, *, tile=64):
    """K4's fp32 FMA body in plain torch, as its CTAs walk the chunk: for
    each head and 64-row i-tile, every j-tile up to the diagonal, the
    scores ``C_i B_j^T`` recomputed per head, ``W = S exp(cum_i - cum_j)
    dt_j`` in fp32 where j <= i and i < Q (nothing evaluated above the
    diagonal), summed as ``W x_j``."""
    B, Q, H, P = xb.shape
    y = torch.zeros((B, Q, H, P))
    for h in range(H):
        for i0 in range(0, Q, tile):
            i1 = min(i0 + tile, Q)
            rows = torch.arange(i0, i1)[:, None]
            for j0 in range(0, i1, tile):
                j1 = min(j0 + tile, Q)
                low = torch.arange(j0, j1)[None, :] <= rows
                S = Cb[:, i0:i1] @ Bb[:, j0:j1].transpose(1, 2)
                seg = cum[:, i0:i1, None, h] - cum[:, None, j0:j1, h]
                W = torch.where(low, S * torch.exp(torch.where(low, seg, 0.0)),
                                0.0) * dtb[:, None, j0:j1, h]
                y[:, i0:i1, h] += W @ xb[:, j0:j1, h]
    return y


@pytest.mark.parametrize("Q,H,N", [(32, 8, 16), (96, 8, 16), (250, 3, 16)],
                         ids=["reduced_chunk", "two_tiles", "ragged"])
def test_ssd_intra_chunk_fp32_head_dim_32_emulation_matches_pallas(Q, H, N):
    """K4's fp32 body at the reduced configs' head dim P = 32 (two output
    columns a thread) and state 16: the reduced chunk (Q = 32, 8 heads),
    two i-tiles, and a ragged chunk of four tiles, emulated tile by tile
    against the Pallas kernel in interpret mode and the JAX oracle (fp32,
    atol 1e-4)."""
    args = _chunk_case(Q + H, 2, Q, H, 32, N)
    got = _k4_fp32_emulation(*(to_torch(a) for a in args))
    want_pl = ssd_intra_chunk_pallas(*(jnp.asarray(a) for a in args),
                                     interpret=True)
    want = jm2._ssd_intra_chunk_jnp(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pl),
                               atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    plain = ops.ssd_intra_chunk(*(to_torch(a) for a in args))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_pl),
                               atol=F32_ATOL)


def _scan_case(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    D = np.ones(H, np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("S", [64, 40, 10],
                         ids=["multiple", "padded", "short"])
def test_ssd_chunked_matches_reference_scan_and_recurrence(S):
    """S a multiple of the chunk (16), S > chunk and not a multiple (the
    padding path), S < chunk (one ragged chunk): y and the final state
    against the JAX scan, y against both packages' naive recurrence."""
    args = _scan_case(S, 2, S, 4, 16, 8)
    y, h = tm2.ssd_chunked(*(to_torch(a) for a in args), chunk=16)
    yj, hj = jm2.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=16)
    assert tuple(y.shape) == (2, S, 4, 16) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=2e-3,
                               rtol=1e-3)
    y_rec = jref.ssd_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_rec), atol=2e-3,
                               rtol=1e-3)
    y_rec_t = tref.ssd_ref(*(to_torch(a) for a in args))
    np.testing.assert_allclose(y_rec_t.numpy(), np.asarray(y_rec),
                               atol=F32_ATOL, rtol=1e-4)


def test_ssd_chunked_launches_the_intra_term_once():
    """The chunks fold into the batch axis: one intra-chunk call per scan,
    whatever the number of chunks."""
    calls = []
    orig = ops.ssd_intra_chunk

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    args = _scan_case(3, 2, 64, 4, 16, 8)
    ops.ssd_intra_chunk = spy
    try:
        tm2.ssd_chunked(*(to_torch(a) for a in args), chunk=16)
    finally:
        ops.ssd_intra_chunk = orig
    assert calls == [torch.Size((8, 16, 4, 16))]


def test_causal_conv1d_and_conv_step_match_reference():
    rng = np.random.default_rng(4)
    B, S, C, W = 2, 11, 24, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    np.testing.assert_allclose(
        tm2.causal_conv1d(to_torch(x), to_torch(w), to_torch(b)).numpy(),
        np.asarray(jm2.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))), atol=F32_ATOL)
    state = rng.standard_normal((B, W - 1, C)).astype(np.float32)
    y_t, s_t = tm2.conv_step(to_torch(state), to_torch(x[:, 0]),
                             to_torch(w), to_torch(b))
    y_j, s_j = jm2.conv_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                             jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=F32_ATOL)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_conv_step_continues_the_prefill_conv():
    """Stepping the conv from the tail of the first S-1 inputs gives the
    prefill conv's last output."""
    rng = np.random.default_rng(5)
    x = to_torch(rng.standard_normal((1, 9, 6)).astype(np.float32))
    w = to_torch(rng.standard_normal((4, 6)).astype(np.float32))
    b = to_torch(rng.standard_normal(6).astype(np.float32))
    full = tm2.causal_conv1d(x, w, b)
    y, _ = tm2.conv_step(x[:, 5:8], x[:, 8], w, b)
    np.testing.assert_allclose(y.numpy(), full[:, 8].numpy(), atol=F32_ATOL)


@pytest.fixture(scope="module")
def ssm():
    return jax_and_port_models("mamba2-780m")


@pytest.mark.parametrize("S", [40, 20])
def test_mamba2_layer_matches_reference(ssm, S):
    """One layer's prefill (output, final state, conv tail) with the JAX
    weights carried by from_jax_params; S = 40 pads to 2 chunks of 32,
    S = 20 is one ragged chunk."""
    jmodel, params, tmodel, cfg = ssm
    lp = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    yj, hj, cj = jm2.mamba2_layer(lp, jnp.asarray(x), cfg, None)
    yt, ht, ct = tm2.mamba2_layer(tmodel.layers[1], to_torch(x), cfg)
    for got, want in ((yt, yj), (ht, hj), (ct, cj)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=1e-4)


def test_mamba2_decode_step_matches_reference(ssm):
    jmodel, params, tmodel, cfg = ssm
    lp = jax.tree_util.tree_map(lambda a: a[2], params["layers"])
    rng = np.random.default_rng(6)
    B, C = 3, cfg.ssm_d_inner + 2 * cfg.ssm_state
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv_width - 1, C)).astype(
        np.float32)
    state = (rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)) * 0.1).astype(np.float32)
    want = jm2.mamba2_decode_step(lp, jnp.asarray(x), jnp.asarray(conv),
                                  jnp.asarray(state), cfg, None)
    got = tm2.mamba2_decode_step(tmodel.layers[2], to_torch(x),
                                 to_torch(conv), to_torch(state), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=1e-4)


@pytest.mark.parametrize("S", [40, 20])
def test_ssm_facade_prefill_and_greedy_decode_match_reference(ssm, S):
    """prefill_state then 4 greedy decode_state steps against the JAX
    facade: logits, greedy tokens, conv and ssm states."""
    jmodel, params, tmodel, cfg = ssm
    prompts = np.random.default_rng(S + 1).integers(
        2, cfg.vocab_size, (2, S)).astype(np.int32)
    facade_parity(jmodel, params, tmodel, cfg, prompts, logit_atol=2e-3,
                  state_atol=F32_ATOL)


def test_ssm_bf16_layer_and_prefill_match_reference():
    """The reduced config in bf16 (the card's dtype): one layer and one
    facade prefill, where the casts of the reference must sit."""
    jmodel, params, tmodel, cfg = jax_and_port_models("mamba2-780m",
                                                      dtype="bfloat16")
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    x = (np.random.default_rng(7).standard_normal((2, 40, cfg.d_model))
         .astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    yj, hj, cj = jm2.mamba2_layer(lp, xj, cfg, None)
    yt, ht, ct = tm2.mamba2_layer(tmodel.layers[0], to_torch(xj), cfg)
    assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
    assert ct.dtype == torch.float32
    for got, want in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2,
                                   rtol=2e-2)
    prompts = np.random.default_rng(8).integers(2, cfg.vocab_size, (2, 40))
    lj, sj = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)}, None)
    lt, st = tmodel.prefill_state(torch.from_numpy(prompts))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2)
    for key in ("conv_state", "ssm_state"):
        got, want = st[key].numpy(), np.asarray(sj[key])
        assert st[key].dtype == torch.float32
        # layer 0 sees the same bf16 inputs on both sides: only the casts
        # can make it differ
        np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=2e-2)
        # deeper layers read bf16 activations that differ by an ulp where
        # two sums rounded differently (one bf16 ulp at |x| ~ 4 is 0.03):
        # held at 2e-2 of the state's scale
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * max(1.0,
                                                   float(np.abs(want).max())))


def test_make_serve_state_matches_reference(ssm):
    jmodel, _, tmodel, _ = ssm
    sj = jmodel.make_serve_state(3, 128, None, filled=5)
    st = tmodel.make_serve_state(3, 128, filled=5)
    assert sorted(st) == sorted(sj)
    for key in sj:
        assert tuple(st[key].shape) == tuple(sj[key].shape), key
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


def test_from_jax_params_fills_every_ssm_parameter(ssm):
    """Every parameter of the reduced ssm model comes from the JAX tree:
    shapes equal, and none is left at the zero init except the norm gains
    and the conv bias (zero in the reference too)."""
    jmodel, params, tmodel, cfg = ssm
    zero_ok = {"norm", "gate_norm", "conv_b", "final_norm"}
    for i, layer in enumerate(tmodel.layers):
        for name in MAMBA2_PARAMS:
            got = getattr(layer, name)
            want = np.asarray(params["layers"][name][i])
            assert tuple(got.shape) == want.shape, name
            np.testing.assert_array_equal(got.numpy(), want)
            if name not in zero_ok:
                assert float(got.abs().max()) > 0, name
    np.testing.assert_array_equal(tmodel.embed.numpy(),
                                  np.asarray(params["embed"]))
    assert not hasattr(tmodel, "lm_head")       # tied embeddings


def test_init_params_ssm_is_seeded_and_scaled():
    """init_params of the reduced ssm config is deterministic for a seed
    and follows the reference's scales (mamba2.py:26-49)."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-780m").reduced()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.layers[0].w_in, c.layers[0].w_in)
    lay = a.layers[1]
    H = cfg.ssm_heads
    dt = torch.nn.functional.softplus(lay.dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    torch.testing.assert_close(lay.A_log, torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)))
    assert torch.equal(lay.D, torch.ones(H))
    assert abs(float(lay.w_in.std()) - cfg.d_model ** -0.5) < 1e-2
    assert abs(float(lay.conv_w.std()) - cfg.ssm_conv_width ** -0.5) < 5e-2
    assert float(lay.norm.abs().max()) == 0.0
