"""Traffic layer: continuous batching with per-tenant QoS lanes (port of
``repro/launch/scheduler.py``).

The :class:`RequestScheduler` closes the loop between request traffic
and the serving engine's round structure.  Each :meth:`step` is one
continuous-batching round (admit and evict EVERY round):

1. **retire** — requests that hit their token budget free their
   sequences (``ServingEngine.free``: queued promotions retire, staging
   slots recycle, host state drops);
2. **resume** — previously preempted requests promote their parked K/V
   bytes back from the spill slots when capacity allows
   (``ServingEngine.resume``), continuing bitwise-identically;
3. **admit** — queued requests enter in tenant-priority order while the
   admission PRECHECK holds (a free batch slot, enough free pool blocks
   with one tail block of headroom per live sequence, enough staging
   slots), so bursts never force an early drain;
4. **preempt** — when a higher-priority request is still waiting,
   victims from strictly-lower-priority tenants demote to the spill
   pools (``ServingEngine.demote``: ``OP_CROSS_POOL_COPY`` rows, the
   reverse of admission promotion).  The victims' blocks return to the
   allocator at the round's flush, so the freed capacity admits the
   waiter NEXT round at no extra launch;
5. **merge + decode** — every tenant lane (a
   :class:`~repro_torch.core.stream.CommandStream` per tenant) is ADOPTED
   into the engine's serve stream in priority order (adoption order is
   issue order in the fused table), then ``decode_round`` drains the
   round's bulk movement as ONE K1 launch and decodes one token for every
   live sequence (K2 in every layer; admissions ran K3 in stage 3).

Quickstart::

    sched = RequestScheduler(eng, [TenantSpec("gold", priority=2),
                                   TenantSpec("free", priority=0)])
    sched.submit("gold", prompt, max_new_tokens=32)
    while not sched.idle:
        report = sched.step()      # one continuous-batching round

Host code only: the scheduler never touches a tensor.  ``RoundReport``'s
``round_us`` / ``p50_round_us`` / ``p99_round_us`` come from the host
clock (:class:`repro_torch.obs.metrics.Stopwatch`); every other field is
a function of the arrival script and the engine's capacities.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.launch.serve import ServingEngine
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract: a name and a priority (higher wins).

    Each tenant gets a dedicated command-stream lane; admission and
    preemption order follow ``priority`` (ties break by submission
    order).  Preemption is strict: a waiting request only evicts victims
    from tenants with STRICTLY lower priority."""

    name: str          #: tenant id (lane name: ``lane:<name>``)
    priority: int = 0  #: higher = more important


@dataclasses.dataclass
class Request:
    """One inference request's lifecycle record.

    ``state`` walks ``queued → running → done`` with a possible
    ``preempted`` detour (demoted to spill, later resumed under a NEW
    engine sid — ``sid`` always names the current sequence).  Round
    indices (``submitted_round``/``first_token_round``/``done_round``)
    let a closed-loop driver compute queueing and token latencies
    without the scheduler owning a clock."""

    rid: int                     #: request id (scheduler-wide)
    tenant: str                  #: owning tenant
    prompt: np.ndarray           #: (S,) int32 prompt tokens
    max_new_tokens: int          #: decode budget
    state: str = "queued"        #: queued|running|preempted|done|cancelled
    sid: Optional[int] = None    #: current engine sequence id
    generated: int = 0           #: decode tokens produced so far
    submitted_round: int = -1    #: round index at submit()
    first_token_round: int = -1  #: round index of the first decode token
    done_round: int = -1         #: round index the request finished
    preemptions: int = 0         #: times this request was demoted
    #: decode tokens produced, in order — survives the sequence's free
    #: (the engine's per-sid history dies with the sid)
    tokens_out: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RoundReport:
    """Accounting for one :meth:`RequestScheduler.step` round."""

    round_index: int             #: which round this was
    launches: int                #: bulk-movement launches (<= 1)
    commands: int                #: command rows the round's flush drained
    admitted: List[int]          #: rids admitted this round
    finished: List[int]          #: rids retired this round
    preempted: List[int]         #: rids demoted this round
    resumed: List[int]           #: rids resumed this round
    tokens: Dict[str, int]       #: decode tokens per tenant this round
    round_us: float = 0.0        #: this round's wall-clock (step() span)
    p50_round_us: float = 0.0    #: running median over rounds so far
    p99_round_us: float = 0.0    #: running p99 over rounds so far


class _Lane:
    """One tenant's admission lane: a FIFO of queued requests plus a
    dedicated CommandStream the lane's bulk movement lands on."""

    def __init__(self, spec: TenantSpec, stream):
        self.spec = spec
        self.stream = stream
        self.queued: Deque[Request] = collections.deque()


class RequestScheduler:
    """Continuous-batching scheduler over a :class:`ServingEngine`.

    Maps tenants onto per-tenant QoS lanes (dedicated command streams),
    admits/evicts every round, and preempts by demotion — see the module
    docstring for the round structure.  The engine must be built with
    ``spill_pages > 0`` for preemption to be available; without it the
    scheduler still batches continuously but never preempts."""

    def __init__(self, eng: ServingEngine, tenants: Sequence[TenantSpec]):
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.eng = eng
        #: lanes in priority order (highest first) — adoption order
        self.lanes: Dict[str, _Lane] = {
            t.name: _Lane(t, eng.engine.stream(f"lane:{t.name}"))
            for t in sorted(tenants, key=lambda t: -t.priority)}
        self.requests: Dict[int, Request] = {}
        self._by_sid: Dict[int, int] = {}     # engine sid -> rid
        self._running: List[int] = []         # rids with a live sequence
        self._preempted: List[int] = []       # rids parked in spill slots
        self._next_rid = 0
        self.round_index = 0
        self.reports: List[RoundReport] = []
        self._round_us: List[float] = []   # per-round wall-clock history

    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        """True when no request is queued, running, or preempted."""
        return not (self._running or self._preempted or
                    any(l.queued for l in self.lanes.values()))

    def submit(self, tenant: str, prompt: np.ndarray,
               max_new_tokens: int = 16) -> int:
        """Queue a request on ``tenant``'s lane; returns the request id.
        Admission happens inside a later :meth:`step` when the precheck
        passes — submit never blocks and never touches the device."""
        if tenant not in self.lanes:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(have {sorted(self.lanes)})")
        req = Request(rid=self._next_rid, tenant=tenant,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      submitted_round=self.round_index)
        self._next_rid += 1
        self.requests[req.rid] = req
        self.lanes[tenant].queued.append(req)
        return req.rid

    def cancel(self, rid: int) -> None:
        """Abort a request in any state.  A running request frees
        mid-round — the lifecycle path ``ServingEngine.free`` fixes:
        queued promotions retire instead of landing in re-issued
        blocks."""
        req = self.requests[rid]
        if req.state == "queued":
            self.lanes[req.tenant].queued.remove(req)
        elif req.state in ("running", "preempted"):
            self.eng.free(req.sid)
            self._by_sid.pop(req.sid, None)
            if rid in self._running:
                self._running.remove(rid)
            if rid in self._preempted:
                self._preempted.remove(rid)
        req.state = "cancelled"
        req.done_round = self.round_index

    # ------------------------------------------------------------------
    # round internals
    # ------------------------------------------------------------------
    def _blocks_needed(self, length: int) -> int:
        page = self.eng.cache.page
        return max((int(length) + page - 1) // page, 0)

    def _admission_room(self, need_blocks: int) -> bool:
        """Admission precheck: a batch slot, free pool blocks with one
        tail block of headroom per live sequence (decode growth must
        never fail mid-round), and staging-ring room so ``stage_blocks``
        cannot force an early drain."""
        cache = self.eng.cache
        if len(cache.seqs) >= cache.max_seqs:
            return False
        headroom = len(cache.seqs)
        if cache.alloc.total_free() < need_blocks + headroom:
            return False
        if self.eng.fused_staging and \
                self.eng.engine.stage_slots_free < need_blocks:
            return False
        return True

    def _retire_finished(self) -> List[int]:
        done = []
        for rid in list(self._running):
            req = self.requests[rid]
            if req.generated >= req.max_new_tokens:
                self.eng.free(req.sid)
                self._by_sid.pop(req.sid, None)
                self._running.remove(rid)
                req.state = "done"
                req.done_round = self.round_index
                done.append(rid)
        return done

    def _admission_room_resume(self, need_blocks: int) -> bool:
        cache = self.eng.cache
        if len(cache.seqs) >= cache.max_seqs:
            return False
        return cache.alloc.total_free() >= need_blocks + len(cache.seqs)

    def _resume_one(self, rid: int) -> bool:
        req = self.requests[rid]
        parked = self.eng.demoted.get(req.sid)
        if parked is None:              # defensive: lost the parking
            self._preempted.remove(rid)
            return False
        if not self._admission_room_resume(len(parked.slots)):
            return False
        new_sid = self.eng.resume(req.sid,
                                  stream=self.lanes[req.tenant].stream)
        self._by_sid.pop(req.sid, None)
        req.sid = new_sid
        self._by_sid[new_sid] = rid
        req.state = "running"
        self._preempted.remove(rid)
        self._running.append(rid)
        return True

    def _admit_and_resume(self) -> tuple:
        """One priority-ordered pass over preempted + queued work.

        Within a lane, parked (preempted) requests resume before new
        admissions — older work first.  Across lanes, strictly priority
        order: a lower-priority lane never resumes into capacity a
        higher-priority waiter is about to admit into (resuming first
        would thrash — resume, demote again, repeat)."""
        admitted, resumed = [], []
        for lane in self.lanes.values():    # already priority-sorted
            parked = [r for r in list(self._preempted)
                      if self.requests[r].tenant == lane.spec.name]
            blocked = False
            for rid in parked:              # preemption order (FIFO)
                if self._resume_one(rid):
                    resumed.append(rid)
                else:
                    blocked = True
                    break
            if blocked:
                continue   # queued work must not overtake parked work
            while lane.queued:
                req = lane.queued[0]
                if not self._admission_room(
                        self._blocks_needed(len(req.prompt))):
                    break
                lane.queued.popleft()
                req.sid = self.eng.add_request(req.prompt,
                                               stream=lane.stream)
                self._by_sid[req.sid] = req.rid
                req.state = "running"
                self._running.append(req.rid)
                admitted.append(req.rid)
        return admitted, resumed

    def _preempt_for_waiters(self) -> List[int]:
        """Demote lowest-priority victims when a strictly-higher-priority
        request is still waiting — the freed blocks come back at the
        round's flush, so the waiter admits next round at zero extra
        launches."""
        if not self.eng.spill_pages:
            return []
        preempted = []
        for lane in self.lanes.values():
            # the lane's frontmost waiter: its oldest parked request
            # (resume blocked this round), else its queued head
            parked = [r for r in self._preempted
                      if self.requests[r].tenant == lane.spec.name]
            if parked:
                need = len(self.eng.demoted[self.requests[parked[0]].sid]
                           .slots)
            elif lane.queued:
                need = self._blocks_needed(len(lane.queued[0].prompt))
            else:
                continue
            if self._admission_room(need):
                continue   # waiting on staging, not on blocks/slots
            # victims: running requests of strictly lower priority,
            # lowest first, newest first within a priority tier
            victims = sorted(
                (r for r in self._running
                 if self.lanes[self.requests[r].tenant].spec.priority
                 < lane.spec.priority),
                key=lambda r: (self.lanes[self.requests[r].tenant]
                               .spec.priority, -r))
            freed = 0
            for vid in victims:
                vreq = self.requests[vid]
                if vreq.sid in self.eng._staged_sids:
                    continue   # admitted this round — demote next round
                vblocks = len(self.eng.cache.blocks_of(vreq.sid))
                if self.eng.engine.spill_slots_free < vblocks:
                    break      # spill parking exhausted
                self.eng.demote(vreq.sid,
                                stream=self.lanes[vreq.tenant].stream)
                # sid stays the key into eng.demoted until resume
                self._running.remove(vid)
                self._preempted.append(vid)
                vreq.state = "preempted"
                vreq.preemptions += 1
                preempted.append(vid)
                freed += vblocks
                if freed >= need:
                    break
        return preempted

    # ------------------------------------------------------------------
    def step(self, sample_fn=None) -> RoundReport:
        """Run ONE continuous-batching round (see the module docstring
        for the five stages) and return its :class:`RoundReport` —
        timed with the shared obs stopwatch, carrying the running
        p50/p99 round latency."""
        with obs_metrics.Stopwatch() as sw:
            finished = self._retire_finished()
            admitted, resumed = self._admit_and_resume()
            preempted = self._preempt_for_waiters()
            # lane merge: adopt every lane's pending rows onto the serve
            # stream in priority order — one flush, one launch, priority
            # traffic first in the fused table
            for lane in self.lanes.values():
                self.eng.stream.adopt(lane.stream)
            toks = self.eng.decode_round(sample_fn=sample_fn)
            per_tenant: Dict[str, int] = {t: 0 for t in self.lanes}
            for sid in toks:
                rid = self._by_sid.get(sid)
                if rid is None:
                    continue
                req = self.requests[rid]
                req.generated += 1
                req.tokens_out.append(int(toks[sid]))
                if req.first_token_round < 0:
                    req.first_token_round = self.round_index
                per_tenant[req.tenant] += 1
        self._round_us.append(sw.us)
        if obs_metrics.metrics_enabled():
            # per-lane lifecycle counters, labeled by tenant
            for rid_list, what in ((admitted, "admitted"),
                                   (finished, "finished"),
                                   (preempted, "preempted"),
                                   (resumed, "resumed")):
                for rid in rid_list:
                    obs_metrics.inc(f"lane.{what}",
                                    tenant=self.requests[rid].tenant)
            for tenant, n in per_tenant.items():
                if n:
                    obs_metrics.inc("lane.tokens", n, tenant=tenant)
            obs_metrics.observe("sched.round_us", sw.us)
        ticket = self.eng.last_ticket
        report = RoundReport(
            round_index=self.round_index,
            launches=ticket.launches if ticket is not None else 0,
            commands=ticket.commands if ticket is not None else 0,
            admitted=admitted, finished=finished,
            preempted=preempted, resumed=resumed, tokens=per_tenant,
            round_us=sw.us,
            p50_round_us=obs_metrics.percentile(self._round_us, 50),
            p99_round_us=obs_metrics.percentile(self._round_us, 99))
        self.reports.append(report)
        self.round_index += 1
        return report

    def drain(self, max_rounds: int = 10_000, sample_fn=None
              ) -> List[RoundReport]:
        """Step until :attr:`idle` (every submitted request finished),
        returning the round reports.  ``max_rounds`` guards against a
        workload that cannot finish (e.g. preempted requests that can
        never resume)."""
        out = []
        for _ in range(max_rounds):
            if self.idle:
                break
            out.append(self.step(sample_fn=sample_fn))
        else:
            raise RuntimeError(f"drain() did not converge in "
                               f"{max_rounds} rounds")
        return out


__all__ = ["RequestScheduler", "TenantSpec", "Request", "RoundReport"]
