"""The port's applications against the JAX package's, on the CPU:

* the PSM migration planner (``core/migration.py``): the same moves, pair
  batches, sequence updates and returned stats on the same cache script,
  and the same pools, journal and engine stats after it ran;
* the Table-1 readout (``launch/mechanisms.py``): the same rows and byte
  columns as ``benchmarks/table1_mechanisms.run()`` (times not compared);
* the Fig-2 readout (``launch/applications.py``) at the reduced
  llama3.2-3b: every stats field of forkbench, buz-init and migrate equals
  the JAX ``_forkbench`` / ``_buz_init`` / ``_migrate`` result, RowClone
  off and on (wall clocks not compared; the random weights differ and the
  stats do not depend on them); ``run`` gives every application's rows,
  the ``checkpoint`` application's training included;
* the serve CLIs fork at the same point (right after admission), so the
  same arguments give the same RowClone stats.
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from test_dispatch_properties import mk_engine
from test_torch_contract import (assert_same_pools, common_stats,
                                 journal_rows, one_thread,
                                 port_engine_like)

import repro.core.migration as jmig
import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.core import PagedCoWCache as JCache
from repro.models import build_model, split_params
import repro_torch.core.migration as tmig
import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config
from repro_torch.core.cow_cache import PagedCoWCache as TCache
from repro_torch.launch import applications, mechanisms
from repro_torch.weights import init_params

ROOT = Path(__file__).resolve().parents[1]


def load_benchmark(name):
    """``benchmarks/<name>.py`` as a module (the folder is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def _mig_script(cache):
    """Four sequences homed on slab 0, one on slab 1, and a fork (its
    shared blocks never migrate); every prompt block holds data."""
    sids = [cache.new_sequence(prompt_len=n, prefer_slab=0)
            for n in (8, 12, 4, 16)]
    sids.append(cache.new_sequence(prompt_len=6, prefer_slab=1))
    for sid in sids:
        cache.alloc.mark_written(cache.blocks_of(sid))
    cache.fork(sids[2], 1)
    return sids


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("rowclone", [True, False])
def test_migration_matches_reference(use_fused, rowclone):
    jeng = mk_engine(64, 1, use_fused=use_fused, stage_nblk=8, seed=7)
    jeng.enable_psm = jeng.enable_fpm = rowclone
    teng = port_engine_like(jeng)
    teng.enable_psm = teng.enable_fpm = rowclone
    jc, tc = JCache(jeng, 4, 8, 8), TCache(teng, 4, 8, 8)
    assert _mig_script(jc) == _mig_script(tc)
    jplan, tplan = jmig.plan_rebalance(jc), tmig.plan_rebalance(tc)
    assert tplan.moves and tplan.moves == jplan.moves
    assert tplan.pair_batches == jplan.pair_batches
    assert tplan.seq_updates == jplan.seq_updates
    assert tmig.execute(tplan, tc, chunk_blocks=2) == \
        jmig.execute(jplan, jc, chunk_blocks=2)
    for sid in jc.seqs:
        assert tc.blocks_of(sid) == jc.blocks_of(sid)
        assert tc.seqs[sid].slab_home == jc.seqs[sid].slab_home
    np.testing.assert_array_equal(tc.alloc.refcount, jc.alloc.refcount)
    assert journal_rows(teng) == journal_rows(jeng)
    j_stats, t_stats = common_stats(jeng, teng)
    assert t_stats == j_stats
    assert (t_stats["psm_copies"] > 0) == rowclone
    assert_same_pools(jeng, teng, "(migration)")


# ---------------------------------------------------------------------------
# Table 1
# ---------------------------------------------------------------------------

def test_table1_rows_match_reference():
    jrows = load_benchmark("table1_mechanisms").run()
    trows = mechanisms.run(device="cpu")
    cols = ("mech", "bytes_compute", "bytes_ici")
    assert [tuple(r[c] for c in cols) for r in trows] == \
        [tuple(r[c] for c in cols) for r in jrows]
    for r in trows:
        assert r["device"] == "cpu" and r["bound_ms"] is None
        assert np.isfinite(r["measured_ms"]) and r["measured_ms"] > 0
    assert trows[0]["speedup_x"] == trows[4]["speedup_x"] == 1.0


def test_table1_small_pool_and_bounds():
    """A smaller pool and block list: the byte columns follow m and the
    block size; ``m`` past half the pool raises."""
    rows = mechanisms.run(device="cpu", nblk=16, m=4, reps=2)
    bb = 64 * 8 * 128 * 4
    moved = {r["mech"]: r["bytes_moved"] for r in rows}
    assert moved == {"copy-baseline": 8 * bb, "copy-fpm": 8 * bb,
                     "copy-zi-alias": 0, "copy-psm": 8 * bb,
                     "zero-baseline": 4 * bb, "zero-buz": 4 * bb,
                     "zero-zi": 0}
    with pytest.raises(ValueError):
        mechanisms.run(device="cpu", nblk=16, m=9)


# ---------------------------------------------------------------------------
# Fig. 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig2_models():
    jcfg = jget_config("llama3.2-3b").reduced()
    jparams, _ = split_params(build_model(jcfg).init_params(
        jax.random.key(0)))
    cfg = get_config("llama3.2-3b").reduced()
    return (jcfg, jparams), (cfg, init_params(cfg, seed=0, device="cpu"))


@pytest.mark.parametrize("app", ["forkbench", "buz-init", "migrate"])
def test_fig2_stats_match_reference(app, fig2_models):
    (jcfg, jparams), (cfg, params) = fig2_models
    jfn = {"forkbench": "_forkbench", "buz-init": "_buz_init",
           "migrate": "_migrate"}[app]
    jfn = getattr(load_benchmark("fig2_applications"), jfn)
    tfn = dict(applications.APPS)[app]
    for on in (False, True):
        want = jfn(jcfg, jparams, on)
        got = tfn(cfg, params, on, applications.resolve_device("cpu"))
        assert got.pop("wall_s") > 0 and want.pop("wall_s") > 0
        assert got == want, (app, on)


@pytest.mark.usefixtures("one_thread")
def test_fig2_run_rows(fig2_models):
    _, (cfg, params) = fig2_models
    rows = applications.run(cfg, params, device="cpu")
    assert [(r["app"], r["rowclone"]) for r in rows] == [
        (a, m) for a, _ in applications.APPS
        for m in ("off", "on", "speedup")]
    by = {(r["app"], r["rowclone"]): r for r in rows}
    assert by[("buz-init", "on")]["zero_lazy"] == 24
    assert by[("buz-init", "off")]["zero_mat"] == 24
    assert by[("migrate", "on")]["bytes_ici"] > 0
    assert by[("forkbench", "on")]["bytes_dma"] > 0


# ---------------------------------------------------------------------------
# serve CLI
# ---------------------------------------------------------------------------

STAT_KEYS = ("fpm", "psm", "alias", "lazy-zero", "bytes_avoided")


def _cli_stats(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "rowclone:" in ln)
    stats = dict(re.findall(r"([\w-]+)=(\d+)", line))
    return {k: int(stats[k]) for k in STAT_KEYS}


@pytest.mark.parametrize("prompt_len", [32, 64])
def test_serve_cli_forks_where_the_reference_does(prompt_len, capsys,
                                                  monkeypatch):
    """A 64-token prompt fills its block, so forking after the first
    round instead (the port's old order) gives other alias / lazy-zero
    counts."""
    args = ["--requests", "2", "--steps", "2", "--fork", "1",
            "--prompt-len", str(prompt_len)]
    want = _cli_stats(jserve.main, ["serve", *args], capsys, monkeypatch)
    got = _cli_stats(tserve.main,
                     ["serve", "--smoke", "--device", "cpu", *args],
                     capsys, monkeypatch)
    assert got == want
