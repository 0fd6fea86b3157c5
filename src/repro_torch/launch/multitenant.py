"""Figure 3/4 analogue — multi-tenant interference, and the traffic driver
(port of ``benchmarks/fig34_multitenant.py``).

Paper Figs. 3/4: multiprogrammed workloads (copy-intensive + memory-
intensive) show RowClone(-ZI) lifting weighted speedup by freeing the
shared memory bus; the benefit grows with the number of copy-intensive
tenants.  Serving analogue (:func:`run`): N decode tenants share one pool.
Some tenants fork + CoW every round (the paper's forkbench), the others
decode plainly.  With RowClone OFF every forked block is copied up front
(``OP_BASELINE_COPY`` rows, one K1 launch per copy); ON the fork shares by
refcount.  Weighted speedup = mean over tenants of t_alone / t_shared,
for 1..3 copy-intensive tenants out of 4.

**Closed-loop traffic driver** (:func:`run_traffic`): requests arrive per
round from a Poisson or bursty process onto the per-tenant QoS lanes
(gold > silver > free) of a
:class:`~repro_torch.launch.scheduler.RequestScheduler` over a deliberately
UNDERSIZED engine, so the round loop exercises continuous admission,
priority preemption by demotion, and resumption.  Reported per tenant:
p50/p99 token latency (rounds between consecutive tokens), time to first
token, goodput (completed requests' tokens/s) and preemption counts; plus
the per-round launch series, which must stay <= 1.

**Dedup traffic leg** (:func:`run_dedup`): several tenants admit the same
canonical prompts; one engine with ``dedup_admit=True`` against an
identical dedup-off twin: resident K/V bytes drop by the shared pages,
greedy tokens stay identical and each round drains <= 1 launch.

Each function takes the reference's arguments and numpy seeding, plus
``device=`` (the card unless the caller asks for the CPU).  The weights
come from :func:`repro_torch.weights.init_params` at the seed, or from the
caller (``params=`` / ``eng=``), which is how the CPU tests feed the JAX
package's weights through.

CLI:  PYTHONPATH=src python -m repro_torch.launch.multitenant \\
          --traffic poisson --rounds 48 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import RowCloneConfig, get_config
from repro_torch.launch.scheduler import (RequestScheduler, RoundReport,
                                          TenantSpec)
from repro_torch.launch.serve import ServingEngine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.weights import init_params

ROUNDS = 4


def _run_mix(cfg, params, n_copy: int, n_plain: int, on: bool) -> float:
    """Seconds of ``ROUNDS`` rounds with ``n_copy`` forking tenants beside
    ``n_plain`` plain decoders, RowClone ``on`` or off (the engine sits
    where ``params`` lie)."""
    rc = RowCloneConfig(enable_fpm=on, enable_psm=on, enable_zi=on)
    eng = ServingEngine(cfg, params, max_seqs=32, rc=rc,
                        device=params.embed.device)
    rng = np.random.default_rng(0)
    plain, copyers = [], []
    for _ in range(n_plain):
        plain.append(eng.add_request(
            rng.integers(2, cfg.vocab_size, size=32).astype(np.int32)))
    for _ in range(n_copy):
        copyers.append(eng.add_request(
            rng.integers(2, cfg.vocab_size, size=32).astype(np.int32)))
    with obs_metrics.Stopwatch() as sw:
        for r in range(ROUNDS):
            # copy-intensive tenants fork every round (children freed
            # after one round: a churning CoW workload)
            kids = []
            for sid in copyers:
                kids.extend(eng.fork(sid, 1))
            if not on:
                # baseline: forks physically copy every block up front,
                # remapped through the cache's public resettlement API
                for sid in kids:
                    fresh = []
                    for b in eng.cache.blocks_of(sid):
                        nb = eng.engine.alloc.alloc_near(b)
                        eng.engine.memcopy([(b, nb)])
                        fresh.append(nb)
                    eng.cache.remap_blocks(sid, fresh)
            eng.decode_round()
            for sid in kids:
                eng.free(sid)
    return sw.s


def run(device="cuda", cfg=None, params=None) -> List[Dict]:
    """Weighted speedups of the 1 / 2 / 3-copy mixes, RowClone off and on.
    ``cfg`` defaults to the reduced yi-6b and ``params`` to its weights at
    seed 0 on ``device``."""
    if cfg is None:
        cfg = get_config("yi-6b").reduced()
    if params is None:
        params = init_params(cfg, seed=0, device=device)
    # alone baseline: one plain tenant
    t_alone = _run_mix(cfg, params, 0, 1, True) / ROUNDS
    rows = []
    for n_copy in (1, 2, 3):
        n_plain = 4 - n_copy
        res = {}
        for on in (False, True):
            t = _run_mix(cfg, params, n_copy, n_plain, on) / ROUNDS
            # weighted speedup proxy: per-round time normalized by tenant
            # count, vs running alone
            ws = t_alone * (n_plain + n_copy) / max(t, 1e-9)
            res["on" if on else "off"] = ws
        rows.append(dict(mix=f"{n_copy}copy+{n_plain}plain",
                         ws_baseline=res["off"], ws_rowclone=res["on"],
                         improvement=res["on"] / max(res["off"], 1e-9)))
    return rows


# ---------------------------------------------------------------------------
# closed-loop traffic driver (RequestScheduler under Poisson/bursty load)
# ---------------------------------------------------------------------------

#: tenant mix for the traffic legs: gold preempts silver preempts free
TENANTS = (TenantSpec("gold", priority=2),
           TenantSpec("silver", priority=1),
           TenantSpec("free", priority=0))

#: mean arrivals per round per tenant for the Poisson process
POISSON_RATES = {"gold": 0.15, "silver": 0.3, "free": 0.6}

#: one arrival of a traffic script: (round, tenant, prompt length,
#: max_new_tokens)
Arrival = Tuple[int, str, int, int]


def _arrivals(pattern: str, rng, round_index: int) -> Dict[str, int]:
    """Arrivals per tenant for one round.

    ``poisson``: independent Poisson counts at :data:`POISSON_RATES`.
    ``bursty``: the free tenant slams 3 requests every 8th round (the
    churn burst that over-commits the undersized pool), gold/silver
    trickle Poisson — the pattern that forces preemption."""
    if pattern == "poisson":
        return {t: int(rng.poisson(POISSON_RATES[t])) for t in POISSON_RATES}
    if pattern == "bursty":
        out = {"gold": int(rng.poisson(0.15)),
               "silver": int(rng.poisson(0.2)),
               "free": 3 if round_index % 8 == 0 else 0}
        return out
    raise ValueError(f"unknown arrival pattern {pattern!r}")


def _pct(xs: List[float], q: float) -> float:
    return obs_metrics.percentile(xs, q)


@dataclasses.dataclass
class TrafficResult:
    """Aggregated output of one :func:`run_traffic` leg.  ``arrivals`` and
    ``reports`` are the port's additions, left out of ``==``: the script
    the leg ran (:func:`run_traffic` ``script=`` replays it) and every
    round's :class:`RoundReport`, drain rounds included."""

    pattern: str                   #: arrival pattern the leg ran
    rounds: int                    #: rounds driven
    launches: List[int]            #: per-round bulk-movement launches
    per_tenant: Dict[str, Dict]    #: tenant -> latency/goodput metrics
    preempted_rids: List[int]      #: requests that were demoted >= once
    completed: int                 #: requests that finished
    submitted: int                 #: requests that arrived
    arrivals: List[Arrival] = dataclasses.field(
        default_factory=list, compare=False, repr=False)
    reports: List[RoundReport] = dataclasses.field(
        default_factory=list, compare=False, repr=False)

    def max_launches_per_round(self) -> float:
        """The worst round's launch count (must stay <= 1)."""
        return float(max(self.launches)) if self.launches else 0.0


def traffic_engine(cfg, params) -> ServingEngine:
    """The traffic legs' deliberately undersized engine (4 batch slots of 8
    blocks over 2 slabs, an 8-slot double-buffered ring, 8 spill slots),
    on ``params``' device."""
    return ServingEngine(cfg, params, max_seqs=4, max_blocks_per_seq=8,
                         num_slabs=2, max_admit_pages=8, double_buffer=True,
                         spill_pages=8, device=params.embed.device)


def run_traffic(pattern: str = "poisson", rounds: int = 48, seed: int = 0,
                arch: str = "llama3.2-3b", max_new_tokens: int = 8,
                eng: ServingEngine = None, device="cuda",
                script: Optional[Sequence[Arrival]] = None
                ) -> TrafficResult:
    """Drive a RequestScheduler closed-loop under ``pattern`` arrivals.

    The engine is deliberately undersized (:func:`traffic_engine`)
    relative to the offered load, so bursts queue, gold arrivals preempt
    free-tenant victims, and victims resume, while every round's bulk
    movement (admission promotions, demote/resume cross-pool copies, CoW
    splits, tail inits) must still drain as at most ONE fused launch.
    Pass ``eng`` to reuse a prebuilt engine (its config and device then
    hold; ``arch`` and ``device`` build one otherwise, from the reduced
    config at seed 0).  ``script`` replays a recorded arrival script
    (``TrafficResult.arrivals``) instead of drawing arrivals: the prompt
    tokens are still drawn from the seeded generator, at ``eng``'s
    vocabulary, so a script recorded at one width replays at another."""
    if eng is None:
        cfg = get_config(arch).reduced()
        eng = traffic_engine(cfg, init_params(cfg, seed=0, device=device))
    cfg = eng.cfg
    sched = RequestScheduler(eng, list(TENANTS))
    rng = np.random.default_rng(seed)
    by_round: Dict[int, List[Arrival]] = {}
    for a in script or ():
        by_round.setdefault(int(a[0]), []).append(a)
    arrivals: List[Arrival] = []
    launches: List[int] = []
    #: per-rid round index of the last emitted token (for inter-token
    #: latency); starts at the submit round
    last_emit: Dict[int, int] = {}
    tok_lat: Dict[str, List[float]] = {t.name: [] for t in TENANTS}
    ttft: Dict[str, List[float]] = {t.name: [] for t in TENANTS}
    round_times: List[float] = []
    prev_gen: Dict[int, int] = {}
    for r in range(rounds):
        todo = by_round.get(r, ()) if script is not None else \
            _drawn(pattern, rng, r, max_new_tokens)
        for a in todo:
            last_emit[_submit(sched, rng, cfg, a)] = r
            arrivals.append(a)
        with obs_metrics.Stopwatch() as sw:
            rep = sched.step()
        round_times.append(sw.s)
        launches.append(rep.launches)
        for rid, req in sched.requests.items():
            new = req.generated - prev_gen.get(rid, 0)
            if new <= 0:
                continue
            first = prev_gen.get(rid, 0) == 0
            prev_gen[rid] = req.generated
            # inter-token latency in rounds: stalls (queueing and
            # preemption parking) stretch exactly this gap
            tok_lat[req.tenant].append(float(max(r - last_emit[rid], 1)))
            last_emit[rid] = r
            if first:
                ttft[req.tenant].append(
                    float(r - req.submitted_round + 1))
    # drain what's in flight so goodput counts whole requests
    extra = 0
    while not sched.idle and extra < 4 * rounds:
        rep = sched.step()
        launches.append(rep.launches)
        extra += 1
    wall = sum(round_times) if round_times else 1e-9
    per_tenant = {}
    for t in TENANTS:
        done = [q for q in sched.requests.values()
                if q.tenant == t.name and q.state == "done"]
        per_tenant[t.name] = dict(
            submitted=sum(1 for q in sched.requests.values()
                          if q.tenant == t.name),
            completed=len(done),
            goodput_tok_s=sum(q.generated for q in done) / wall,
            p50_token_latency_rounds=_pct(tok_lat[t.name], 50),
            p99_token_latency_rounds=_pct(tok_lat[t.name], 99),
            p50_ttft_rounds=_pct(ttft[t.name], 50),
            preemptions=sum(q.preemptions for q in done))
    return TrafficResult(
        pattern=pattern, rounds=rounds, launches=launches,
        per_tenant=per_tenant,
        preempted_rids=[q.rid for q in sched.requests.values()
                        if q.preemptions],
        completed=sum(1 for q in sched.requests.values()
                      if q.state == "done"),
        submitted=len(sched.requests), arrivals=arrivals,
        reports=list(sched.reports))


def _drawn(pattern: str, rng, r: int, max_new_tokens: int):
    """Round ``r``'s arrivals, drawn lazily: each prompt length is drawn
    only after the previous arrival's prompt, the reference's order of
    draws from one generator."""
    for tenant, n in _arrivals(pattern, rng, r).items():
        for _ in range(n):
            yield (r, tenant, int(rng.integers(8, 17)), max_new_tokens)


def _submit(sched: RequestScheduler, rng, cfg, arrival: Arrival) -> int:
    """Submit one arrival with a prompt drawn from ``rng`` (the
    reference's draw, after the prompt length)."""
    _, tenant, plen, max_new = arrival
    prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
    return sched.submit(tenant, prompt, max_new_tokens=max_new)


# ---------------------------------------------------------------------------
# dedup-on-admit traffic leg (duplicated prompts across tenants)
# ---------------------------------------------------------------------------

def run_dedup(rounds: int = 4, seed: int = 0, arch: str = "llama3.2-3b",
              tenants: int = 4, cfg=None, params=None,
              device="cuda") -> Dict:
    """Duplicated-prompt traffic: ``tenants`` admissions drawn from TWO
    canonical prompts (so most admissions are exact dupes of an earlier
    tenant's), decoded for ``rounds`` greedy rounds with dedup-on-admit
    ON and then on an identical dedup-off twin.  Returns peak resident K/V
    bytes for both runs, the reduction, launches/round, and whether every
    tenant's greedy tokens matched bitwise.  Without ``cfg`` the reduced
    ``arch`` runs with its weights at seed 0 on ``device``; the engines
    sit where ``params`` lie."""
    if cfg is None:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, seed=0, device=device)

    def drive(dedup: bool):
        eng = ServingEngine(cfg, params, max_seqs=max(tenants * 2, 8),
                            dedup_admit=dedup, device=params.embed.device)
        rng = np.random.default_rng(seed)
        page = eng.cache.page
        canon = [rng.integers(2, cfg.vocab_size,
                              size=2 * page + page // 2).astype(np.int32)
                 for _ in range(2)]
        sids = [eng.add_request(canon[t % len(canon)].copy())
                for t in range(tenants)]
        peak = eng.kv_bytes_live()
        launches = []
        for _ in range(rounds):
            eng.decode_round()
            launches.append(eng.last_ticket.launches
                            if eng.last_ticket else 0)
            peak = max(peak, eng.kv_bytes_live())
        toks = [tuple(eng.tokens[s]) for s in sids]
        return eng, toks, peak, launches

    e_on, tok_on, peak_on, l_on = drive(True)
    e_off, tok_off, peak_off, l_off = drive(False)
    return dict(
        tenants=tenants, rounds=rounds,
        kv_bytes_live_on=int(peak_on), kv_bytes_live_off=int(peak_off),
        resident_reduction=1.0 - peak_on / max(peak_off, 1),
        dedup_hits=int(e_on.dedup_hits),
        pages_shared=int(e_on.dedup_pages_shared),
        bytes_saved=int(e_on.dedup_bytes_saved),
        tokens_match=bool(tok_on == tok_off),
        max_launches_per_round=float(max(l_on)) if l_on else 0.0)


def main():
    """CLI for the traffic driver (the Fig. 3/4 sweep stays importable)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", choices=("poisson", "bursty", "dedup"),
                    default="poisson")
    ap.add_argument("--rounds", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.traffic == "dedup":
        row = run_dedup(rounds=min(args.rounds, 8), seed=args.seed,
                        device=args.device)
        print(f"[traffic:dedup] {row['tenants']} tenants: resident KV "
              f"{row['kv_bytes_live_on']} vs {row['kv_bytes_live_off']} B "
              f"({row['resident_reduction']:.0%} saved), "
              f"{row['pages_shared']} pages shared, tokens_match="
              f"{row['tokens_match']}, max launches/round "
              f"{row['max_launches_per_round']:.1f}")
        return
    res = run_traffic(args.traffic, rounds=args.rounds, seed=args.seed,
                      device=args.device)
    print(f"[traffic:{res.pattern}] {res.submitted} arrived, "
          f"{res.completed} completed, "
          f"max launches/round {res.max_launches_per_round():.1f}, "
          f"{len(res.preempted_rids)} requests preempted")
    for t, m in res.per_tenant.items():
        print(f"  {t:>6}: {m['completed']}/{m['submitted']} done  "
              f"p50/p99 tok-lat {m['p50_token_latency_rounds']:.1f}/"
              f"{m['p99_token_latency_rounds']:.1f} rounds  "
              f"goodput {m['goodput_tok_s']:.1f} tok/s  "
              f"preemptions {m['preemptions']}")


if __name__ == "__main__":
    main()
