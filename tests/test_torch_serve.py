"""The port's ServingEngine against the JAX fused ServingEngine (the default
engine, not the ``fused_staging=False`` leg): admit 3 prompts of ragged
length, run a round, fork the first into 2, run 5 more rounds — 6 in all.

* greedy tokens are identical; every step's top-1 / top-2 logit margin is
  asserted to exceed twice the logit tolerance, so an argmax flip could
  only come from a real divergence;
* logits agree within atol 4e-3 (both heads are bf16 products, see
  test_torch_model.py);
* bulk-movement launches are <= 1 per round on both engines;
* ``pool_bytes_resident`` and ``kv_bytes_live`` are equal.
"""
import jax
import numpy as np
import pytest

from test_torch_contract import PortHook

from repro.configs import get_config as jget_config
from repro.kernels import fused_dispatch as jfd
from repro.launch.serve import ServingEngine as JServing
from repro.models import build_model, split_params
from repro_torch.configs import get_config
from repro_torch.launch.serve import ServingEngine
from repro_torch.weights import from_jax_params

LOGIT_ATOL = 4e-3
PROMPT_LENS = (20, 45, 70)
#: prompt seed; random weights give near-uniform logits, and with this
#: seed every greedy step keeps a top-1 / top-2 margin above 2 x LOGIT_ATOL
PROMPT_SEED = 27
ROUNDS = 6
#: sampler seed of the sample_fn test; with it every draw keeps a top-1 /
#: top-2 margin above 2 x LOGIT_ATOL
SAMPLE_SEED = 0


def _margin(logits):
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _engines():
    jcfg = jget_config("llama3.2-3b").reduced()
    params, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config("llama3.2-3b").reduced()
    tmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             cfg, device="cpu")
    return (JServing(jcfg, params, max_seqs=8),
            ServingEngine(cfg, tmodel, max_seqs=8, device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _round(eng, hook_ctx, fork_sid=None):
    with hook_ctx as events:
        if fork_sid is not None:
            eng.fork(fork_sid, 2)
        toks = eng.decode_round()
    return toks, [m for _, _, m in events]


class _JaxHook:
    def __enter__(self):
        self.events = []
        self._fn = lambda n, p, m: self.events.append((n, p, m))
        jfd.add_launch_hook(self._fn)
        return self.events

    def __exit__(self, *exc):
        jfd.remove_launch_hook(self._fn)


def test_scripted_serve_matches_reference(engines):
    jeng, teng = engines
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(2, 512, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    with _JaxHook() as ev_j, PortHook() as ev_t:
        sids_j = [jeng.add_request(p.copy()) for p in prompts]
        sids_t = [teng.add_request(p.copy()) for p in prompts]
    assert sids_j == sids_t and ev_j == ev_t == []   # promotions queue
    for sid in sids_t:
        np.testing.assert_allclose(teng.last_logits[sid],
                                   jeng.last_logits[sid], atol=LOGIT_ATOL)
    for rnd in range(ROUNDS):
        fork = sids_j[0] if rnd == 1 else None
        for sid, lg in jeng.last_logits.items():
            assert _margin(lg) > 2 * LOGIT_ATOL, (rnd, sid, _margin(lg))
        toks_j, mech_j = _round(jeng, _JaxHook(), fork)
        toks_t, mech_t = _round(teng, PortHook(), fork)
        assert toks_t == toks_j, rnd
        assert len(mech_t) <= 1 and len(mech_j) <= 1, (rnd, mech_t)
        assert mech_t == mech_j, rnd
        for sid in toks_t:
            np.testing.assert_allclose(teng.last_logits[sid],
                                       jeng.last_logits[sid],
                                       atol=LOGIT_ATOL, err_msg=str(rnd))
    assert teng.tokens == jeng.tokens
    assert teng.pool_bytes_resident() == jeng.engine.pool_bytes_resident()
    assert teng.kv_bytes_live() == jeng.kv_bytes_live()
    s_t, s_j = teng.engine.stats, jeng.engine.stats
    assert (s_t.launches, s_t.stage_promotions, s_t.fpm_copies) == \
        (s_j.launches, s_j.stage_promotions, s_j.fpm_copies)
    assert s_t.launches == 2          # admission round + fork split round


def test_free_before_flush_retires_promotion():
    """A sequence freed before the round's flush retires its queued
    promotion rows and recycles its staging slots (no launch)."""
    cfg = get_config("llama3.2-3b").reduced()
    from repro_torch.weights import init_params
    eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                        max_seqs=4, max_blocks_per_seq=4, device="cpu")
    free0, live0 = eng.engine.stage_slots_free, eng.kv_bytes_live()
    sid = eng.add_request(np.arange(2, 80, dtype=np.int32))
    assert eng.engine.stage_slots_free == free0 - 2
    eng.free(sid)
    assert eng.engine.stats.retired_promotions == 4     # 2 pages x k, v
    assert eng.engine.stage_slots_free == free0
    assert len(eng.stream) == 0 and eng.kv_bytes_live() == live0
    assert eng.decode_round() == {} and eng.engine.stats.launches == 0


class GumbelSampler:
    """A seeded sampler: argmax of the logits plus Gumbel noise from its own
    numpy generator (the Gumbel-max draw from softmax(logits)); records
    each draw's top-1 / top-2 margin."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.margins = []
        self.greedy = []

    def __call__(self, logits):
        z = logits + self.rng.gumbel(size=logits.shape)
        self.margins.append(_margin(z))
        self.greedy.append(int(np.argmax(z)) == int(np.argmax(logits)))
        return int(np.argmax(z))


def test_decode_round_sample_fn_matches_reference():
    """``decode_round(sample_fn=...)`` as the reference's: the same seeded
    sampler over both engines' logits gives the same tokens, round by
    round, through a fork; the draws are not all greedy, and every draw's
    margin exceeds twice the logit tolerance, so a differing token could
    only come from a real divergence."""
    jeng, teng = _engines()
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(2, 512, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    sids = [jeng.add_request(p.copy()) for p in prompts]
    assert [teng.add_request(p.copy()) for p in prompts] == sids
    samp_j, samp_t = GumbelSampler(SAMPLE_SEED), GumbelSampler(SAMPLE_SEED)
    for rnd in range(3):
        if rnd == 1:
            assert jeng.fork(sids[0], 2) == teng.fork(sids[0], 2)
        toks_j = jeng.decode_round(sample_fn=samp_j)
        toks_t = teng.decode_round(sample_fn=samp_t)
        assert toks_t == toks_j, rnd
    assert teng.tokens == jeng.tokens
    assert min(samp_j.margins) > 2 * LOGIT_ATOL, min(samp_j.margins)
    assert not all(samp_j.greedy)
    assert samp_t.greedy == samp_j.greedy
