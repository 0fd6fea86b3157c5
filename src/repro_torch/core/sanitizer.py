"""Drain sanitizer — dynamic validation of every flushed table (port of
``repro/core/sanitizer.py``).

``RowCloneEngine(sanitize=True)`` (or ``REPRO_SANITIZE=1`` at
construction) attaches a :class:`DrainSanitizer`, and every chunk that
reaches ``_dispatch_table`` is validated BEFORE its launch:

* every opcode has a registry entry (core/opcodes.py) and every operand
  decodes under its contract (primary ids in range, global ids locatable,
  packed two-source ids inside the ``total²`` square);
* a destination in a non-primary pool is legal only where the opcode's
  ``staging_dst_ok`` says so;
* padding rows are exactly ``(OP_NOP, -1, -1)``;
* no RAW / WAW pair coexists in one table.  This is K1's wave contract:
  ``wave_schedule`` (kernels/fused_dispatch.py) refuses such a pair, and
  the sanitizer names it before the C library does;
* no adjacent WAR pair: the reference's spacer contract
  (``space_war_rows``), which the port keeps for journal parity, so the
  check describes the tables the port drains.  K1 itself orders every WAR
  writer after its readers by waves, adjacent or not;
* (sampled) shadow execution: host copies of every pool taken before the
  launch (``core/journal.to_host``, bfloat16 as uint16 bits) run through
  the plain drain (kernels/ref.py ``fused_dispatch``) on the CPU, and
  every pool the real drain left is compared with the result bit for bit.
  On the card this holds K1 to its plain version on live traffic.  The
  plain drain calls no ``notify_launch`` and bumps no engine stats, so
  launch accounting is the same with the sanitizer on.

The snapshot is a blocking device-to-host copy on the current stream, so
it follows every earlier write of the pools (drains, the decode step's
append, the checkpoint stream's windows, all issued on that stream); the
post-launch read is issued after K1's launch on the same stream.  A pool
that cannot be copied (a killed pool) makes the snapshot raise.

Failures raise :class:`SanitizerError` carrying a :class:`SanitizerReport`;
the drain's abort path stashes the undispatched suffix as for any
mid-flush failure.  The check ids and messages are the reference's, so
both packages report the same findings on the same table.

On an engine over a rank mesh, :meth:`DrainSanitizer.check_plan` also
holds every ``ShardPlan`` to the rows it partitions (the same global read
and write sets, every rank's sub-table WAR-spaced) between partitioning
and the sharded drain's launches.
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.journal import to_host
from repro_torch.core.opcodes import (ALL_PRIMARY, OP_NOP, UnknownOpcodeError,
                                      keys_clash, opspec, row_rw,
                                      unpack_bitwise_src)


def sanitize_enabled() -> bool:
    """Is drain sanitizing requested by the environment?  True when
    ``REPRO_SANITIZE`` is set to anything but ``""`` / ``"0"``."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation in one flushed table: the stable check id
    (e.g. ``"war-adjacency"``, ``"shadow-diff"``), the message, and the
    table row it anchors to (-1 for whole-table findings)."""

    check: str
    message: str
    row: int = -1


@dataclasses.dataclass(frozen=True)
class SanitizerReport:
    """The result of sanitizing one dispatched chunk: where it sits in the
    engine's drain sequence (``flush`` / ``chunk``), its real (non-padding)
    rows, the checks that ran and the findings (empty when clean)."""

    flush: int
    chunk: int
    rows: int
    checks: Tuple[str, ...]
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        """True when every check passed."""
        return not self.findings


class SanitizerError(RuntimeError):
    """A sanitized drain found an invariant violation before the launch
    (or a shadow diff after it); ``.report`` is the
    :class:`SanitizerReport`."""

    def __init__(self, report: SanitizerReport):
        self.report = report
        lines = [f"drain sanitizer: {len(report.findings)} finding(s) in "
                 f"flush {report.flush} chunk {report.chunk}:"]
        lines += [f"  [{f.check}] row {f.row}: {f.message}"
                  for f in report.findings]
        super().__init__("\n".join(lines))


#: checks run on every table (check_table)
_TABLE_CHECKS = ("opcode-registry", "nop-well-formed", "operand-contract",
                 "staging-legality", "raw-waw-free", "war-adjacency")
#: checks run on every sharded plan (check_plan)
_PLAN_CHECKS = ("plan-partition", "plan-war-adjacency")


class DrainSanitizer:
    """Validates every flushed table an engine dispatches (see the module
    docstring).  Keeps the last ``max_reports`` receipts on ``reports``
    and running totals (``tables_checked`` / ``shadow_runs``).

    ``shadow_every`` samples the shadow execution: 1 (default) shadows
    every chunk, ``n`` every n-th; the static checks always run.  The
    sample is a deterministic counter, so a sanitized replay shadows the
    same chunks as the original drain."""

    def __init__(self, engine, shadow_every: int = 1,
                 max_reports: int = 256):
        self.engine = weakref.proxy(engine)    # the engine owns its sanitizer
        self.shadow_every = max(int(shadow_every), 1)
        self.max_reports = max_reports
        self.reports: List[SanitizerReport] = []
        self.tables_checked = 0
        self.plans_checked = 0
        self.shadow_runs = 0
        self._chunk_counter = 0
        self._ctx: Tuple[int, int] = (-1, -1)

    # ------------------------------------------------------------------
    def _emit(self, findings: List[Finding], checks: Tuple[str, ...],
              n_rows: int) -> None:
        flush, chunk = self._ctx
        report = SanitizerReport(flush=flush, chunk=chunk, rows=n_rows,
                                 checks=checks, findings=tuple(findings))
        self.reports.append(report)
        if len(self.reports) > self.max_reports:
            del self.reports[:-self.max_reports]
        if findings:
            raise SanitizerError(report)

    def _locate(self, gid: int) -> Tuple[int, int]:
        return self.engine.group.locate(int(gid))

    # ------------------------------------------------------------------
    def check_table(self, table: np.ndarray, flush: int, chunk: int,
                    spaced: bool = True) -> None:
        """Run every static check on one bucket-padded chunk; raises
        :class:`SanitizerError` when any fails.  Called by the drain after
        the drain guards and before the launch.  ``spaced=False`` (a table
        the sharded drain partitions: its rank sub-tables are spaced and
        :meth:`check_plan` checks them) leaves out ``war-adjacency``,
        which the reference runs there too and so refuses every adjacent
        write-after-read pair of a sanitized mesh engine (ROADMAP §3)."""
        self._ctx = (flush, chunk)
        self.tables_checked += 1
        group = self.engine.group
        total = group.total_blocks
        nblk = self.engine.num_blocks
        primary = group.primary
        findings: List[Finding] = []
        decoded: List[Optional[Tuple[Tuple, Tuple]]] = []
        n_rows = 0
        for i, (op, s, d) in enumerate(np.asarray(table).tolist()):
            if op < 0:
                if (op, s, d) != (OP_NOP, -1, -1):
                    findings.append(Finding(
                        "nop-well-formed",
                        f"padding row must be (OP_NOP, -1, -1), got "
                        f"({op}, {s}, {d})", i))
                decoded.append(None)
                continue
            n_rows += 1
            try:
                sp = opspec(op)
            except UnknownOpcodeError as e:
                findings.append(Finding("opcode-registry", str(e), i))
                decoded.append(None)
                continue
            rw = self._check_row(sp, op, s, d, nblk, total, findings, i)
            decoded.append(rw)
            if rw is None:
                continue
            _, writes = rw
            for p, _b in writes:
                if p != ALL_PRIMARY and not primary[p] \
                        and not sp.staging_dst_ok:
                    findings.append(Finding(
                        "staging-legality",
                        f"{sp.constant_name} dst resolves to non-primary "
                        f"pool {group.names[p]!r} but its contract "
                        "forbids staging destinations", i))
        self._check_order(decoded, primary, findings, war=spaced)
        self._emit(findings, _TABLE_CHECKS if spaced else tuple(
            c for c in _TABLE_CHECKS if c != "war-adjacency"), n_rows)

    def _check_row(self, sp, op: int, s: int, d: int, nblk: int,
                   total: int, findings: List[Finding], i: int):
        """Validate one row's operands under ``sp``'s contract; returns
        the decoded ``(reads, writes)`` keys, or None when undecodable."""
        name = sp.constant_name
        ok = True
        if sp.src_kind == "none" and s != -1:
            findings.append(Finding(
                "operand-contract",
                f"{name} takes no source but src={s} (must be -1)", i))
        elif sp.src_kind == "primary" and not 0 <= s < nblk:
            findings.append(Finding(
                "operand-contract",
                f"{name} src {s} outside the primary address space "
                f"[0, {nblk})", i))
            ok = False
        elif sp.src_kind == "global" and not 0 <= s < total:
            findings.append(Finding(
                "operand-contract",
                f"{name} src {s} outside the global id space "
                f"[0, {total})", i))
            ok = False
        elif sp.src_kind == "packed":
            try:
                unpack_bitwise_src(s, total)
            except ValueError as e:
                findings.append(Finding("operand-contract",
                                        f"{name}: {e}", i))
                ok = False
        if sp.dst_kind == "primary" and not 0 <= d < nblk:
            findings.append(Finding(
                "operand-contract",
                f"{name} dst {d} outside the primary address space "
                f"[0, {nblk}) — the written block must be named in dst",
                i))
            ok = False
        elif sp.dst_kind == "global" and not 0 <= d < total:
            findings.append(Finding(
                "operand-contract",
                f"{name} dst {d} outside the global id space [0, {total})"
                " — the written block must be named in dst", i))
            ok = False
        if not ok:
            return None
        return row_rw(op, s, d, self._locate, total)

    def _check_order(self, decoded, primary, findings: List[Finding],
                     check_prefix: str = "", war: bool = True) -> None:
        """Whole-table RAW / WAW absence and (``war``) adjacent-row WAR
        disjointness over the decoded ``(reads, writes)`` of each row
        (None = padding or undecodable: padding resets the adjacency
        window, as the spacer does)."""
        written: List[Tuple[Tuple[int, int], int]] = []
        prev_reads: Tuple = ()
        for i, rw in enumerate(decoded):
            if rw is None:
                prev_reads = ()
                continue
            reads, writes = rw
            for r in reads:
                for w, j in written:
                    if keys_clash(r, w, primary):
                        findings.append(Finding(
                            check_prefix + "raw-waw-free",
                            f"row reads {r} written by row {j} in the "
                            "same table (RAW must flush-split)", i))
            for wk in writes:
                for w, j in written:
                    if keys_clash(wk, w, primary):
                        findings.append(Finding(
                            check_prefix + "raw-waw-free",
                            f"row rewrites {wk} written by row {j} in "
                            "the same table (WAW must flush-split)", i))
            if war and any(keys_clash(r, w, primary)
                           for r in prev_reads for w in writes):
                findings.append(Finding(
                    check_prefix + "war-adjacency",
                    "row writes a block the immediately preceding row "
                    "reads — the overlapped drain's trailing wait races "
                    "this (missing OP_NOP spacer)", i))
            written.extend((w, i) for w in writes)
            prev_reads = reads

    # ------------------------------------------------------------------
    def check_plan(self, rows: Sequence[Tuple[int, int, int]], plan,
                   replicated: Tuple[bool, ...]) -> None:
        """Validate a :class:`~repro_torch.core.cmdqueue.ShardPlan`
        against the rows it partitions: the per-rank sub-tables plus the
        transfer plan must reproduce exactly the global read and write key
        sets of the flushed rows, and every sub-table must honour the WAR
        adjacency contract on its own.  Called by ``_dispatch_sharded``
        between partitioning and the launches."""
        self.plans_checked += 1
        group = self.engine.group
        primary = group.primary
        ss = plan.shard_sizes
        local_base: List[int] = []
        run = 0
        for s_p in ss:
            local_base.append(run)
            run += s_p
        lt = run
        ss0 = ss[primary.index(True)]

        def _local_locate(gid: int) -> Tuple[int, int]:
            for p in range(len(ss) - 1, -1, -1):
                if gid >= local_base[p]:
                    return p, gid - local_base[p]
            raise ValueError(f"slab-local id {gid} below every pool base")

        def _expand(key: Tuple[int, int]) -> Set[Tuple[int, int]]:
            p, b = key
            if p == ALL_PRIMARY:
                return {(q, b) for q, is_p in enumerate(primary) if is_p}
            return {(p, b)}

        def _globalize(key: Tuple[int, int], sh: int) -> Tuple[int, int]:
            p, b = key
            if p == ALL_PRIMARY:
                return (p, sh * ss0 + b)
            if replicated[p]:
                return (p, b)
            return (p, sh * ss[p] + b)

        findings: List[Finding] = []
        want_reads: Set[Tuple[int, int]] = set()
        want_writes: Set[Tuple[int, int]] = set()
        for op, s, d in rows:
            if op < 0:
                continue
            reads, writes = row_rw(op, s, d, self._locate,
                                   group.total_blocks)
            for r in reads:
                want_reads |= _expand(r)
            for w in writes:
                want_writes |= _expand(w)

        got_reads: Set[Tuple[int, int]] = set()
        got_writes: Set[Tuple[int, int]] = set()
        for sh in range(plan.n_shards):
            decoded = []
            for op, s, d in np.asarray(plan.local_tables[sh]).tolist():
                if op < 0:
                    decoded.append(None)
                    continue
                rw = row_rw(op, s, d, _local_locate, lt)
                decoded.append(rw)
                reads, writes = rw
                for r in reads:
                    got_reads |= _expand(_globalize(r, sh))
                for w in writes:
                    got_writes |= _expand(_globalize(w, sh))
            self._check_order(decoded, primary, findings,
                              check_prefix="plan-")
        S = plan.n_shards
        for k, delta in enumerate(plan.deltas):
            for sh_d in range(S):
                sh_s = (sh_d - delta) % S
                for j in range(plan.recv_tables.shape[2]):
                    bp, dp, dr, _comb = (
                        int(x) for x in plan.recv_tables[k, sh_d, j])
                    if dr < 0:
                        continue
                    src_row = int(plan.send_rows[k, sh_s, j])
                    got_reads |= _expand(_globalize(
                        (ALL_PRIMARY if bp < 0 else bp, src_row), sh_s))
                    got_writes |= _expand(_globalize(
                        (ALL_PRIMARY if dp < 0 else dp, dr), sh_d))

        for label, want, got in (("write", want_writes, got_writes),
                                 ("read", want_reads, got_reads)):
            missing = sorted(want - got)[:4]
            extra = sorted(got - want)[:4]
            if missing or extra:
                findings.append(Finding(
                    "plan-partition",
                    f"ShardPlan {label} set diverges from the flushed "
                    f"rows: missing {missing}, extra {extra} "
                    "((pool, block) keys, truncated)"))
        self._emit(findings, _PLAN_CHECKS,
                   sum(1 for op, _s, _d in rows if op >= 0))

    # ------------------------------------------------------------------
    def shadow_snapshot(self) -> Optional[Dict[str, np.ndarray]]:
        """Host copies of every pool for the shadow diff, or None when
        this chunk is not sampled (``shadow_every``).  Taken BEFORE the
        launch, since the drain writes the pools in place; raises when a
        pool cannot be copied (a killed pool)."""
        from repro_torch.kernels.ref import require_live
        self._chunk_counter += 1
        if (self._chunk_counter - 1) % self.shadow_every:
            return None
        pools = self.engine.pools
        require_live(list(pools.values()))
        return {n: to_host(p) for n, p in pools.items()}

    def check_shadow(self, pre: Dict[str, np.ndarray],
                     table: np.ndarray) -> None:
        """Drain ``table`` with the plain version on CPU tensors over the
        pre-launch host copies and compare every pool bit for bit with
        what the real drain left.  Any differing block is a finding: the
        kernel diverged from the plain version on live traffic."""
        import torch

        from repro_torch.kernels import ref as _ref
        eng = self.engine
        self.shadow_runs += 1
        # CPU tensors over the host copies' memory (bfloat16 bits viewed
        # back): the plain drain rewrites ``pre`` in place
        want = []
        for name, p in eng.pools.items():
            a = pre[name]
            w = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                 else a)
            want.append(w.view(p.dtype) if w.dtype != p.dtype else w)
        zeros = tuple(z.cpu() for z in eng._get_zero_blocks())
        _ref.fused_dispatch(want, zeros, np.asarray(table, np.int32),
                            block_axis=eng.block_axis,
                            primary=eng.group.primary)
        findings: List[Finding] = []
        ba = eng.block_axis
        for name in eng.pools:
            got, w = to_host(eng.pools[name]), pre[name]
            if got.tobytes() == w.tobytes():
                continue
            diff = (np.moveaxis(got, ba, 0).reshape(got.shape[ba], -1)
                    != np.moveaxis(w, ba, 0).reshape(w.shape[ba], -1))
            bad = np.nonzero(diff.any(axis=1))[0]
            # the reference's message, word for word (findings compare
            # equal across the packages)
            findings.append(Finding(
                "shadow-diff",
                f"pool {name!r}: {len(bad)} block(s) differ from the jnp "
                f"oracle after dispatch (first: {bad[:8].tolist()})"))
        self._emit(findings, ("shadow-diff",),
                   int((np.asarray(table)[:, 0] >= 0).sum()))


__all__ = ["DrainSanitizer", "Finding", "SanitizerError", "SanitizerReport",
           "sanitize_enabled"]
