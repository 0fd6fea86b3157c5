"""The port's drain sanitizer against the JAX package's, on the same tables
(``tests/test_rowlint_sanitizer.py:177-248`` and its ``REPRO_SANITIZE=1``
streams, run on both packages).

* each seeded violation raises ``SanitizerError`` on both sanitizers with
  the same findings, compared as ``(check, row, message)``, and leaves the
  pools untouched (fail-stop), the shadow diff included (a corrupted
  drain that the plain version disagrees with);
* a clean drain leaves the same receipts;
* a finding in a later chunk takes the abort path: the dispatched prefix
  journaled ``aborted``, the suffix stashed, as the reference's;
* ``REPRO_SANITIZE=1`` attaches the sanitizer at construction: the
  dispatch property streams give the same launch events and pools as an
  unsanitized twin and as the JAX sanitized engine, with the same
  ``tables_checked`` / ``shadow_runs``.

Tolerances: pools bitwise, findings and counts exact.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from test_dispatch_properties import gen_program, run_program
from test_dispatch_properties import mk_engine as jax_prop_engine
from test_torch_contract import (assert_same_pools, bits,
                                 journal_rows, port_engine_like,
                                 run_program_port, to_torch)

import repro.core as jcore
import repro.core.opcodes as joc
import repro.kernels.ops as jkops
import repro_torch.core.opcodes as toc
import repro_torch.kernels.ops as tkops
import repro_torch.obs.trace as ttrace
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.core.sanitizer import (DrainSanitizer, SanitizerError,
                                        sanitize_enabled)

OP_FPM_COPY, OP_NOP, OP_AND = toc.OP_FPM_COPY, toc.OP_NOP, toc.OP_AND


def jax_sane_engine(nblk=8):
    """test_rowlint_sanitizer.py's engine."""
    alloc = jcore.SubarrayAllocator(nblk, 4, reserved_zero_per_slab=1)
    pools = {
        "k": jax.random.normal(jax.random.key(0), (nblk, 4, 8)),
        "k_stage": jax.random.normal(jax.random.key(1), (nblk, 4, 8)),
    }
    return jcore.RowCloneEngine(pools, alloc, max_requests=64,
                                use_fused=True, staging={"k_stage": "k"},
                                sanitize=True)


def port_sane_engine(jeng):
    """The port's engine on the same bytes, sanitized (pools that own
    their storage, so that a test can kill one)."""
    a = jeng.alloc
    return RowCloneEngine({n: to_torch(p).clone()
                           for n, p in jeng.pools.items()},
                          SubarrayAllocator(a.num_blocks, a.num_slabs,
                                            reserved_zero_per_slab=1),
                          max_requests=64, staging=dict(jeng.staging),
                          sanitize=True)


def pool_bits(eng):
    return {n: bits(p.clone() if isinstance(p, torch.Tensor) else p)
            for n, p in eng.pools.items()}


def findings(report):
    return [(f.check, f.row, f.message) for f in report.findings]


# ---------------------------------------------------------------------------
# seeded violations: the same findings on both packages, fail-stop
# ---------------------------------------------------------------------------

def _adjacent_war(total):
    # row 1 writes block 0, which row 0 reads: the dropped-spacer race
    return [(OP_FPM_COPY, 0, 1), (OP_FPM_COPY, 2, 0)]


def _raw_pair(total):
    # row 1 reads block 1, which row 0 writes: must have been flush-split
    return [(OP_FPM_COPY, 0, 1), (OP_NOP, -1, -1), (OP_FPM_COPY, 1, 2)]


def _malformed_nop(total):
    return [(OP_NOP, 3, 7)]


def _misdeclared_dst(total):
    # a bitwise row whose dst is outside the global id space
    return [(OP_AND, toc.pack_bitwise_src(1, 2, total), total + 5)]


def _unknown_opcode(total):
    return [(42, 0, 1)]


def _staging_illegal_dst(total):
    # aimed at the stage ring; the test tightens the registry entry
    return [(toc.OP_CROSS_POOL_COPY, 0, 8 + 1)]


def _shadow_diff(total):
    return [(OP_FPM_COPY, 0, 1)]


CASES = {"adjacent_war": (_adjacent_war, "war-adjacency"),
         "raw_pair": (_raw_pair, "raw-waw-free"),
         "malformed_nop": (_malformed_nop, "nop-well-formed"),
         "misdeclared_dst": (_misdeclared_dst, "operand-contract"),
         "unknown_opcode": (_unknown_opcode, "opcode-registry"),
         "staging_illegal_dst": (_staging_illegal_dst, "staging-legality"),
         "shadow_diff": (_shadow_diff, "shadow-diff")}


def _corrupt_jax(monkeypatch):
    real = jkops.fused_dispatch

    def bad(pools, zero_blocks, cmds, **kw):
        out = list(real(pools, zero_blocks, cmds, **kw))
        out[0] = out[0].at[2].add(1.0)
        return tuple(out)

    monkeypatch.setattr(jkops, "fused_dispatch", bad)


def _corrupt_port(monkeypatch):
    real = tkops.fused_dispatch

    def bad(pools, zero_blocks, cmds, **kw):
        out = real(pools, zero_blocks, cmds, **kw)
        pools[0][2].add_(1.0)
        return out

    monkeypatch.setattr(tkops, "fused_dispatch", bad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sanitizer_catches_like_reference(case, monkeypatch):
    """One of the reference's seven catch tests on both sanitizers: the
    drain raises SanitizerError with the expected check and the same
    ``(check, row, message)`` findings, and no pool changed except where
    the planted corrupt drain ran (shadow diff: the kernel, not the
    sanitizer, wrote them)."""
    make_rows, check = CASES[case]
    jeng = jax_sane_engine()
    teng = port_sane_engine(jeng)
    if case == "staging_illegal_dst":
        for oc in (joc, toc):
            sp = oc.OPCODES[oc.OP_CROSS_POOL_COPY]
            monkeypatch.setitem(oc.OPCODES, oc.OP_CROSS_POOL_COPY,
                                dataclasses.replace(sp,
                                                    staging_dst_ok=False))
    if case == "shadow_diff":
        _corrupt_jax(monkeypatch)
        _corrupt_port(monkeypatch)
    rows = make_rows(teng.group.total_blocks)
    assert jeng.group.base("k_stage") == 8
    got = []
    for eng, err in ((jeng, jcore.SanitizerError), (teng, SanitizerError)):
        before = pool_bits(eng)
        with pytest.raises(err) as ei:
            eng._drain_rows(rows, pre_spaced=True)
        rep = ei.value.report
        assert check in {f.check for f in rep.findings} and not rep.ok
        if case == "shadow_diff":
            assert {f.check for f in rep.findings} == {"shadow-diff"}
        else:
            after = pool_bits(eng)
            for n in before:
                np.testing.assert_array_equal(after[n], before[n])
        got.append((findings(rep), rep.flush, rep.chunk, rep.rows,
                    rep.checks, str(ei.value)))
    assert got[1] == got[0]
    assert ttrace._STACK == []


def test_sanitizer_clean_drain_reports():
    """A clean drain: one table receipt and one shadow receipt, the same
    as the reference's, pools bitwise equal."""
    jeng = jax_sane_engine()
    teng = port_sane_engine(jeng)
    rows = [(OP_FPM_COPY, 0, 1), (OP_NOP, -1, -1), (OP_FPM_COPY, 2, 3)]
    for eng in (jeng, teng):
        eng._drain_rows(rows, pre_spaced=True)
        san = eng.sanitizer
        assert san.tables_checked == 1 and san.shadow_runs == 1
        assert all(r.ok for r in san.reports)
        assert san.reports[0].rows == 2
        assert "war-adjacency" in san.reports[0].checks
        assert san.reports[-1].checks == ("shadow-diff",)
    assert [dataclasses.asdict(r) for r in teng.sanitizer.reports] == \
        [dataclasses.asdict(r) for r in jeng.sanitizer.reports]
    assert_same_pools(jeng, teng, "clean drain")


def test_sanitizer_finding_in_a_later_chunk_aborts_like_reference():
    """A malformed row in the second chunk of a 600-row flush: the first
    chunk dispatched and is journaled ``aborted``, the rest is stashed;
    the same records and stash as the reference's, pools bitwise."""
    nblk = 2048
    jalloc = jcore.SubarrayAllocator(nblk, 4, reserved_zero_per_slab=1)
    jeng = jcore.RowCloneEngine(
        {"k": jax.random.normal(jax.random.key(3), (nblk, 2, 4))}, jalloc,
        sanitize=True)
    teng = port_sane_engine(jeng)
    rows = [(OP_FPM_COPY, 2 * i, 2 * i + 1) for i in range(600)]
    rows[550] = (OP_NOP, 5, 5)
    for eng, err in ((jeng, jcore.SanitizerError), (teng, SanitizerError)):
        with pytest.raises(err) as ei:
            eng._drain_rows(rows, pre_spaced=True)
        assert ei.value.report.chunk == 1
        assert eng.journal.records[-1].aborted
        assert len(eng.journal.records[-1].rows) == 512
        assert len(eng._aborted[0].suffix) == 600 - 512
        assert eng.sanitizer.tables_checked == 2
        assert eng.sanitizer.shadow_runs == 1
    assert journal_rows(teng) == journal_rows(jeng)
    assert [(a.queue, a.index, a.rows, a.suffix) for a in teng._aborted] == \
        [(a.queue, a.index, a.rows, a.suffix) for a in jeng._aborted]
    assert_same_pools(jeng, teng, "aborted flush")
    assert ttrace._STACK == []


def test_sanitizer_snapshot_of_a_killed_pool_raises():
    """The shadow snapshot refuses a killed pool before it reads it: the
    drain raises, nothing is shadowed, and the flush is stashed."""
    teng = port_sane_engine(jax_sane_engine())
    teng.kill_pool("k_stage")
    with pytest.raises(RuntimeError, match="no storage"):
        teng._drain_rows([(OP_FPM_COPY, 0, 1)], pre_spaced=True)
    assert teng.sanitizer.tables_checked == 1
    assert teng.sanitizer.shadow_runs == 0
    assert len(teng._aborted) == 1


@pytest.mark.parametrize("every", [1, 2, 3])
def test_shadow_sampling_matches_reference(every):
    """``shadow_every`` samples chunks by a counter: the same chunks are
    shadowed on both packages."""
    jeng = jax_sane_engine()
    teng = port_sane_engine(jeng)
    for eng in (jeng, teng):
        eng.sanitizer = (DrainSanitizer(eng, shadow_every=every)
                         if eng is teng else
                         jcore.DrainSanitizer(eng, shadow_every=every))
        for i in range(5):
            eng._drain_rows([(OP_FPM_COPY, i, 7 - i % 2)], pre_spaced=True)
    assert teng.sanitizer.shadow_runs == jeng.sanitizer.shadow_runs \
        == -(-5 // every)
    assert teng.sanitizer.tables_checked == jeng.sanitizer.tables_checked
    assert_same_pools(jeng, teng, f"shadow_every={every}")


# ---------------------------------------------------------------------------
# REPRO_SANITIZE=1: property streams, sanitized vs plain twin vs the JAX one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sanitized_streams_bitwise_and_launch_parity(monkeypatch, seed):
    """The environment attaches the sanitizer at construction; a
    sanitized stream launches and moves exactly as its unsanitized twin
    and as the JAX sanitized engine, with zero findings and the
    reference's coverage counts."""
    prog = gen_program(random.Random(seed), 16, 6)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled()
    jeng = jax_prop_engine(16, 0, True, seed=seed)
    teng_s = port_engine_like(jeng)
    assert teng_s.sanitizer is not None and jeng.sanitizer is not None
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    teng_p = port_engine_like(jeng)
    assert teng_p.sanitizer is None

    events_j = run_program(jeng, prog)
    events_s = run_program_port(teng_s, prog)
    events_p = run_program_port(teng_p, prog)
    assert events_s == events_p == events_j
    assert_same_pools(jeng, teng_s, f"sanitized, seed={seed}")
    for name in teng_s.pools:
        np.testing.assert_array_equal(bits(teng_s.pools[name]),
                                      bits(teng_p.pools[name]))
    san, jsan = teng_s.sanitizer, jeng.sanitizer
    assert san.tables_checked > 0
    assert san.shadow_runs == san.tables_checked
    assert (san.tables_checked, san.shadow_runs) == \
        (jsan.tables_checked, jsan.shadow_runs)
    assert all(r.ok for r in san.reports)
