#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and build — needs ``torch.cuda.is_available()``; prints the card's
   name and power limit (``nvidia-smi``) and builds every kernel of the
   port from ``src/repro_torch/csrc`` (nvcc, all sources in parallel).
2. K1, the fused command drain, against its plain version at the serving
   pool shapes (four bf16 pools ``(28, nblk, 64, 8, 128)`` and the staging
   ring): every opcode, NOP padding, non-adjacent write-after-read pairs
   (three waves) and a staging role vector; bitwise equality.
3. K2, paged decode attention, against its plain version at B=8, H=24,
   KVH=8, D=128, page=64, with CoW-shared blocks and an empty slot.
4. K3, prefill attention, against its plain version at B=1, H=24, KVH=8,
   D=128, causal, S=512 and a ragged S=250; SDPA is timed beside it as a
   yardstick only (the port never calls it).
5. serve llama3.2-3b at full width (28 layers, d_model 3072, bf16, random
   weights from seed 0): admit 4 prompts, run one round, fork the first
   sequence into 2, run 15 more rounds.  Checks the launch counts of every
   kernel on that run, finite logits, and the first round's logits against
   the same admissions and round run through the plain versions on the card.
6. K5a (FPM copy), K5b (pool-to-pool copy) and K6 (BuZ zero-init) against
   their plain versions, bitwise, at full width: flat pools of 14,336
   llama3.2-3b K/V pages ``(14336, 64, 8, 128)`` bf16 and phase 2's
   layer-stacked ``(28, 512, 64, 8, 128)``, m = 8 and 256 blocks per call,
   ``-1`` padding and an in-call write-after-read pair; kernel, plain and
   library-call times beside the byte bound.
7. the fused drain against the per-mechanism fan-out: one fixed op script
   (``launch/mechanisms.py ab_program``: every mechanism, 419 rows) through
   two engines over identical full-width flat pools; pools bitwise equal, 1
   launch per flush fused and ``AB_FANOUT_LAUNCHES`` fanned out (the count
   the CPU tests pin against the JAX engine); ms per flush of each.  The
   fan-out run is K5a's, K5b's and K6's main path: their launch counts are
   read around it.
8. Table 1 (``launch/mechanisms.py run``) on a phase-6 pool, m = 8 and 256,
   and Fig. 2 (``launch/applications.py run``) at llama3.2-3b full width
   with phase 5's weights, RowClone off and on.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and the device JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

SEED = 0
PROMPT_LENS = (96, 250, 384, 512)
ROUNDS = 16
MAX_SEQS = 8
MAX_BLOCKS_PER_SEQ = 64

# tolerances, with their reasons
#: K2: fp32 accumulation in another order and the fast exp; outputs are
#: O(1) averages of bf16 values
K2_ATOL = 2e-3
#: K3: bf16 output (one bf16 ulp at |x| ~ 2-4 is 1.6e-2), as the JAX tests
K3_ATOL = 2e-2
#: serve logits: 28 bf16 layers run through two attention implementations
#: (different summation orders, bf16 re-rounding of every activation)
SERVE_RTOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, scrub=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events;
    ``scrub`` (a large buffer) is rewritten before each launch so that the
    call finds the 50 MB L2 cold, as the serving path does."""
    from repro_torch.launch.mechanisms import time_ms as timed
    return timed(fn, torch.device("cuda"), reps=reps, scrub=scrub)


def device_ms(fn, key: str = "", reps: int = 5):
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    self device time of the CUDA events whose name holds ``key`` (every
    device event for ``key=""``), over ``reps`` calls; None when the
    profiler recorded no device time.  Unlike :func:`time_ms` it leaves
    out the host work between two launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key)
    return total / reps / 1e3 if total else None


def _fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    build.build_all()
    log(f"[build] kernels built in {build.last_build_seconds:.1f} s")
    for name, out in build.last_build_log.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return smi


def phase_k1(scrub):
    from repro_torch.core.opcodes import pack_bitwise_src
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_dispatch import wave_schedule
    L, nblk, ring, page, kvh, D = 28, MAX_SEQS * MAX_BLOCKS_PER_SEQ, \
        MAX_BLOCKS_PER_SEQ, 64, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def pool(n):
        return torch.randn((L, n, page, kvh, D), generator=gen,
                           device="cuda").to(torch.bfloat16)

    pools = [pool(nblk), pool(nblk), pool(ring), pool(ring)]
    primary = (True, True, False, False)
    sizes = [nblk, nblk, ring, ring]
    bases, total, _ = ref.address_space(sizes)
    K, V, KS, VS = bases
    pk = lambda a, b: pack_bitwise_src(a, b, total)   # noqa: E731
    rows = [
        (0, 10, 20), (1, 30, 200), (2, 40, 41), (3, -1, 50),
        (4, KS + 3, K + 60), (4, VS + 3, V + 60), (4, K + 70, KS + 5),
        (5, pk(K + 80, V + 81), K + 82), (-1, -1, -1),
        (6, pk(KS + 7, K + 83), V + 84), (7, pk(V + 85, V + 85), VS + 9),
        (0, 100, 101),
        (0, 90, 10),              # WAR on row 0's source, not adjacent
        (4, K + 91, KS + 3),      # WAR on a promotion's staging source
        (0, 102, 100),            # WAR on (0, 100, 101): wave 1
        (3, -1, 102),             # WAR on the row above: wave 2
    ]
    live = [r for r in rows if r[0] >= 0]
    waves = wave_schedule(live, sizes, primary)
    table = np.full((32, 3), -1, np.int32)
    table[:len(rows)] = rows
    zero_blocks = [torch.zeros((1, page, kvh, D), dtype=torch.bfloat16,
                               device="cuda") for _ in pools]
    want = [p.clone() for p in pools]
    ref.fused_dispatch(want, zero_blocks, table, block_axis=1,
                       primary=primary)
    ops.fused_dispatch(pools, zero_blocks, table, block_axis=1,
                       primary=primary, use_kernel=True)
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(pools, want))
           if not torch.equal(a.view(torch.int16), b.view(torch.int16))]
    if bad:
        raise AssertionError(f"K1 differs from its plain version in pools "
                             f"{bad}")
    page_bytes = page * kvh * D * 2
    moved = 0
    for op, s, d in live:
        pages = 2 if op <= 3 else 1          # plain rows: both primaries
        reads = 0 if op == 3 else (2 if op in (5, 6) else 1)
        moved += pages * L * page_bytes * (reads + 1)
    ms = time_ms(lambda: ops.fused_dispatch(
        pools, zero_blocks, table, block_axis=1, primary=primary,
        use_kernel=True), scrub=scrub)
    plain_ms = time_ms(lambda: ops.fused_dispatch(
        pools, zero_blocks, table, block_axis=1, primary=primary,
        use_kernel=False), reps=5, scrub=scrub)
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"[K1] bitwise equal to plain on {len(live)} rows "
        f"({max(waves) + 1} waves); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({moved} bytes)")
    del pools, want
    return dict(name="fused_dispatch", source="src/repro_torch/csrc/"
                "fused_dispatch.cu",
                replaces="src/repro/kernels/fused_dispatch.py:406",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None)


def phase_k2(scrub):
    from repro_torch.kernels import ops
    B, H, KVH, D, page, nblk = MAX_SEQS, 24, 8, 128, 64, \
        MAX_SEQS * MAX_BLOCKS_PER_SEQ
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((nblk, page, KVH, D), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((nblk, page, KVH, D), generator=gen,
                    device="cuda").bfloat16()
    mask = np.zeros((nblk, B), np.int8)
    base = np.zeros(nblk, np.int32)
    lens = np.zeros(B, np.int32)
    free = list(rng.permutation(nblk))
    shared = [free.pop() for _ in range(3)]      # a forked 3-page prompt
    for b in range(B - 1):                        # slot B-1 stays empty
        n = int(rng.integers(1, 9))
        blocks = (shared if b < 3 else []) + [free.pop() for _ in range(n)]
        for j, blk in enumerate(blocks):
            mask[blk, b] = 1
            base[blk] = j * page
        lens[b] = (len(blocks) - 1) * page + int(rng.integers(1, page + 1))
    args = (q, k, v, torch.from_numpy(mask).cuda(),
            torch.from_numpy(base).cuda(), torch.from_numpy(lens).cuda())
    acc, l, m = ops.paged_attention_slab(*args, page=page, use_kernel=True)
    acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=page,
                                               use_kernel=False)
    torch.cuda.synchronize()
    out = acc / l.clamp_min(1e-30)[..., None]
    out_p = acc_p / l_p.clamp_min(1e-30)[..., None]
    err = float((out - out_p).abs().max())
    err_m = float((m - m_p).abs().max())
    empty_ok = bool((m[B - 1] == -1e30).all() and (l[B - 1] == 0).all()
                    and (acc[B - 1] == 0).all())
    if not (err <= K2_ATOL and err_m <= K2_ATOL and empty_ok):
        raise AssertionError(f"K2 vs plain: out err {err}, m err {err_m}, "
                             f"empty slot ok {empty_ok}")
    live_blocks = int((mask.sum(1) > 0).sum())
    nbytes = live_blocks * page * KVH * D * 2 * 2 + q.numel() * 2 + \
        B * H * (D + 2) * 4
    ms = time_ms(lambda: ops.paged_attention_slab(*args, page=page,
                                                  use_kernel=True),
                 scrub=scrub)
    plain_ms = time_ms(lambda: ops.paged_attention_slab(
        *args, page=page, use_kernel=False), reps=5, scrub=scrub)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[K2] max |out - plain| {err:.2e}, |m - plain| {err_m:.2e} "
        f"(atol {K2_ATOL}); empty slot m=-1e30 l=0; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes)")
    return dict(name="paged_attention", source="src/repro_torch/csrc/"
                "paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:98",
                max_abs_err=max(err, err_m), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


def phase_k3(scrub):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    B, H, KVH, D = 1, 24, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {}
    for S in (512, 250):
        q = torch.randn((B, H, S, D), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((B, KVH, S, D), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((B, KVH, S, D), generator=gen,
                        device="cuda").bfloat16()
        out = ops.flash_attention(q, k, v, causal=True, use_kernel=True)
        want = ops.flash_attention(q, k, v, causal=True, use_kernel=False)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        if not err <= K3_ATOL:
            raise AssertionError(f"K3 vs plain at S={S}: max err {err}")
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 use_kernel=True),
                     scrub=scrub)
        plain_ms = time_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, use_kernel=False), reps=5, scrub=scrub)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), scrub=scrub)
        flops = 4.0 * B * H * D * (S * (S + 1) / 2)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        b_ops = flops / BF16_FLOPS * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[K3] S={S}: max err {err:.2e} (atol {K3_ATOL}); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {max(b_ops, b_bytes):.5f} ms ({flops:.3e} flop, "
            f"{nbytes} bytes)")
        rows[S] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                       bound=max(b_ops, b_bytes),
                       by="operations" if b_ops >= b_bytes else "bytes")
    r = rows[512]
    return dict(name="flash_attention", source="src/repro_torch/csrc/"
                "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:93",
                max_abs_err=max(x["err"] for x in rows.values()),
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"],
                bound_by=r["by"], library_ms=r["lib_ms"])


def profile_rounds(eng, rounds: int = 3) -> None:
    """Where a steady round's time goes: torch.profiler over ``rounds``
    more decode rounds (after the counted run), device time per kernel and
    the device's idle share of the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.decode_round()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for avg in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): a CPU op's
        # device time repeats the kernels it launched
        if avg.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(avg, "self_device_time_total", 0.0)
        if dev > 0:
            rows.append((dev, avg.count, avg.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log("[profile] device time: not measured (the profiler recorded "
            "no kernel)")
        return
    log(f"[profile] {rounds} steady rounds: wall {wall_us / rounds / 1e3:.2f}"
        f" ms/round, device busy {busy / rounds / 1e3:.2f} ms/round, idle "
        f"share {1 - busy / wall_us:.3f}")
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        log(f"[profile]   {dev / rounds / 1e3:8.3f} ms/round "
            f"{count // rounds:5d} calls/round  {key[:90]}")


def _admit_all(eng, prompts):
    return [eng.add_request(p) for p in prompts]


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[serve] {cfg.arch_id}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f} B params "
        f"({n_bytes / 1e9:.2f} GB), init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ)
    log(f"[serve] pools {eng.pool_bytes_resident() / 1e9:.2f} GB "
        f"(K/V pools {eng.engine.pools['k'].numel() * 2 / 1e9:.2f} GB each)")

    counters = ops.KERNEL_COUNTERS
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t_admit = time.perf_counter()
    sids = _admit_all(eng, prompts)
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t_admit
    round_ms, fused_per_round, bulk = [], [], []
    first_logits = None
    n_tokens = 0
    for rnd in range(ROUNDS):
        if rnd == 1:
            eng.fork(sids[0], 2)
        before = counters["fused_dispatch"].n
        t = time.perf_counter()
        out = eng.decode_round()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        n_tokens += len(out)
        fused_per_round.append(counters["fused_dispatch"].n - before)
        bulk.append(eng.last_ticket.commands > 0)
        if rnd == 0:
            first_logits = {s: eng.last_logits[s].copy() for s in sids}
    launches = {n: c.n for n, c in counters.items()}
    finite = all(np.isfinite(lg).all() for lg in eng.last_logits.values())
    L = cfg.num_layers
    checks = {
        "fused <= 1 per round": max(fused_per_round) <= 1,
        "fused == 1 on every round with bulk work":
            all(f == 1 for f, b in zip(fused_per_round, bulk) if b),
        "K2 launches == layers x rounds":
            launches["paged_attention"] == L * ROUNDS,
        "K3 launches == layers x admissions":
            launches["flash_attention"] == L * len(prompts),
        "logits finite": finite,
    }
    steady = float(np.median(round_ms[2:]))
    log(f"[serve] admitted {len(prompts)} prompts {PROMPT_LENS} in "
        f"{t_admit * 1e3:.1f} ms; {ROUNDS} rounds, median "
        f"{steady:.2f} ms/round (rounds 3-{ROUNDS}), "
        f"{n_tokens / (sum(round_ms) / 1e3):.1f} tokens/s over all rounds; "
        f"fused launches per round {fused_per_round}")
    log(f"[serve] kernels: K1 fused_dispatch={launches['fused_dispatch']} "
        f"K2 paged_attention={launches['paged_attention']} "
        f"K3 flash_attention={launches['flash_attention']}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    profile_rounds(eng)

    # the same admissions and first round through the plain versions
    del eng
    torch.cuda.empty_cache()
    with ops.plain_versions():
        plain = ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                              max_blocks_per_seq=MAX_BLOCKS_PER_SEQ)
        psids = _admit_all(plain, prompts)
        plain.decode_round()
    errs, scale = [], 0.0
    for s, ps in zip(sids, psids):
        a, b = first_logits[s], plain.last_logits[ps]
        errs.append(float(np.abs(a - b).max()))
        scale = max(scale, float(np.abs(b).max()))
    agree = sum(int(np.argmax(first_logits[s]) == np.argmax(
        plain.last_logits[ps])) for s, ps in zip(sids, psids))
    log(f"[serve] round-1 logits vs plain versions: max |diff| "
        f"{max(errs):.3e} (limit {SERVE_RTOL} x max |logit| = "
        f"{SERVE_RTOL * scale:.3e}); argmax agrees on {agree}/{len(sids)}")
    if not max(errs) <= SERVE_RTOL * scale:
        raise AssertionError("serve logits differ from the plain versions")
    del plain
    return launches, cfg, params


# ---------------------------------------------------------------------------
# phases 6-8: the per-mechanism slice
# ---------------------------------------------------------------------------

#: flat pools of phase 6/7: the 28 x 512 pages phase 5's K pool holds
FLAT_NBLK = 28 * MAX_SEQS * MAX_BLOCKS_PER_SEQ
#: rows of one fan-out call (the engine's max_requests)
MAX_REQUESTS = 256


def _bf16_pool(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _copy_ids(rng, nblk, m, n_src=None):
    """m live ``[src, dst]`` rows (dsts distinct, none a source) with one
    write-after-read pair (row m // 2 rewrites row 0's source, in-pool
    only), padded with -1 rows to 256 (m = 8) or by 8 rows (m = 256)."""
    if n_src is None:
        perm = rng.permutation(nblk)
        srcs, dsts = perm[:m], perm[m:2 * m].copy()
        dsts[m // 2] = srcs[0]
    else:
        srcs = rng.permutation(n_src)[:m]
        dsts = rng.permutation(nblk)[:m]
    pad = max(MAX_REQUESTS - m, 8)
    live = np.stack([srcs, dsts], 1)
    return np.concatenate([live, np.full((pad, 2), -1)]).astype(np.int32)


def _bitwise_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def phase_copy_kernels(scrub):
    """Phase 6: K5a, K5b, K6 against their plain versions; timings."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    page_bytes = 64 * 8 * 128 * 2
    shapes = {0: (FLAT_NBLK, 64, 8, 128),
              1: (28, MAX_SEQS * MAX_BLOCKS_PER_SEQ, 64, 8, 128)}
    pools = {ba: (_bf16_pool(shp, gen), _bf16_pool(shp, gen))
             for ba, shp in shapes.items()}
    rows = {}
    for ba, (a, b) in pools.items():
        nblk = a.shape[ba]
        L = a.shape[0] if ba == 1 else 1
        for m in (8, MAX_REQUESTS):
            ids = _copy_ids(rng, nblk, m)
            xids = _copy_ids(rng, nblk, m, n_src=nblk)
            zids = ids[:, 1].copy()
            live = ids[ids[:, 1] >= 0]
            xlive = xids[xids[:, 1] >= 0]
            t_src, t_dst = (torch.from_numpy(live[:, i].astype(np.int64))
                            .cuda() for i in (0, 1))
            x_src, x_dst = (torch.from_numpy(xlive[:, i].astype(np.int64))
                            .cuda() for i in (0, 1))
            calls = {
                "fpm_copy": (
                    lambda p, k: ops.fpm_copy(p, ids, block_axis=ba,
                                              use_kernel=k),
                    lambda p: p.index_copy_(ba, t_dst,
                                            p.index_select(ba, t_src)), 2),
                "fpm_copy_cross": (
                    lambda p, k: ops.fpm_copy_cross(p, b, xids,
                                                    block_axis=ba,
                                                    use_kernel=k),
                    lambda p: p.index_copy_(ba, x_dst,
                                            b.index_select(ba, x_src)), 2),
                "zero_init": (
                    lambda p, k: ops.meminit_zero(p, zids, block_axis=ba,
                                                  use_kernel=k),
                    lambda p: p.index_fill_(ba, t_dst, 0), 1),
            }
            for name, (fn, lib, passes) in calls.items():
                want = fn(a.clone(), False)
                got = fn(a.clone(), True)
                torch.cuda.synchronize()
                if not _bitwise_equal(got, want):
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version (axis {ba}, m={m})")
                del want, got
                ms = time_ms(lambda: fn(a, True), scrub=scrub)
                plain_ms = time_ms(lambda: fn(a, False), reps=5,
                                   scrub=scrub)
                lib_ms = time_ms(lambda: lib(a), scrub=scrub)
                dev = device_ms(lambda: fn(a, True), key="move_kernel")
                nbytes = passes * m * L * page_bytes
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"[{name}] axis {ba} m={m}: bitwise equal to plain "
                    f"(padding, WAR pair); kernel {ms:.4f} ms (device "
                    f"only {_fmt_ms(dev)}), plain {plain_ms:.4f} ms, "
                    f"library {lib_ms:.4f} ms, bound {bound:.4f} ms "
                    f"({nbytes} bytes)")
                rows[(name, ba, m)] = dict(ms=ms, plain_ms=plain_ms,
                                           library_ms=lib_ms,
                                           bound_ms=bound)
        # pool-to-pool copy within ONE pool: its WAR pair is ordered too
        ids = _copy_ids(rng, nblk, 8)
        want = ops.fpm_copy_cross(a.clone(), a, ids, block_axis=ba,
                                  use_kernel=False)
        c = a.clone()
        got = ops.fpm_copy_cross(c, c, ids, block_axis=ba, use_kernel=True)
        torch.cuda.synchronize()
        if not _bitwise_equal(got, want):
            raise AssertionError(f"fpm_copy_cross within one pool differs "
                                 f"(axis {ba})")
        del want, got, c
    sources = {"fpm_copy": ("fpm_copy.cu", "src/repro/kernels/fpm_copy.py:60"),
               "fpm_copy_cross": ("fpm_copy.cu",
                                  "src/repro/kernels/fpm_copy.py:101"),
               "zero_init": ("zero_init.cu",
                             "src/repro/kernels/zero_init.py:46")}
    out = []
    for name, (src, replaces) in sources.items():
        r = rows[(name, 0, MAX_REQUESTS)]
        out.append(dict(name=name, source=f"src/repro_torch/csrc/{src}",
                        replaces=replaces, max_abs_err=0.0,
                        bound_by="bytes", **r))
    return out, pools[0][0]


def phase_ab(flat):
    """Phase 7: the fused drain against the fan-out over identical pools.
    Returns the launch counts of the fan-out run (the copy kernels' main
    path)."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import mechanisms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    v = _bf16_pool(flat.shape, gen)
    stage = [_bf16_pool((64,) + tuple(flat.shape[1:]), gen)
             for _ in range(2)]

    def engine(use_fused):
        pools = {"k": flat.clone(), "v": v.clone(),
                 "k_stage": stage[0].clone(), "v_stage": stage[1].clone()}
        return RowCloneEngine(pools, SubarrayAllocator(FLAT_NBLK, 4),
                              use_fused=use_fused,
                              staging={"k_stage": "k", "v_stage": "v"})

    prog = mechanisms.ab_program(FLAT_NBLK)
    fanout, fused = engine(False), engine(True)
    counters = ops.KERNEL_COUNTERS
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    mechanisms.drive(fanout, prog)
    torch.cuda.synchronize()
    launches = {n: c.n for n, c in counters.items()}
    for c in counters.values():
        c.reset()
    mechanisms.drive(fused, prog)
    torch.cuda.synchronize()
    fused_launches = {n: c.n for n, c in counters.items()}
    bad = [n for n in fused.pools
           if not _bitwise_equal(fused.pools[n], fanout.pools[n])]
    rows = fused.journal.records[-1].rows
    n_live = sum(1 for r in rows if r[0] >= 0)
    n_fused, n_fanout = fused.stats.launches, fanout.stats.launches
    checks = {
        "pools bitwise equal": not bad,
        "fused: 1 launch per flush": n_fused == 1
        and fused_launches["fused_dispatch"] == 1,
        "fan-out launches == CPU-pinned count":
            n_fanout == mechanisms.AB_FANOUT_LAUNCHES,
        "same table": fanout.journal.records[-1].rows == rows,
        "K5a, K5b, K6 launched": all(launches[k] > 0 for k in (
            "fpm_copy", "fpm_copy_cross", "zero_init")),
        "no fused launch on the fan-out": launches["fused_dispatch"] == 0,
    }
    # ms per flush: re-drain the same table, in turns
    times = {True: [], False: []}
    for use_fused in (True, False, False, True, True, False):
        eng = fused if use_fused else fanout
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._drain_rows(rows)
        torch.cuda.synchronize()
        times[use_fused].append((time.perf_counter() - t0) * 1e3)
    dev = {f: device_ms(lambda: e._drain_rows(rows), reps=3)
           for f, e in ((True, fused), (False, fanout))}
    log(f"[A/B] device time per flush (profiler): fused "
        f"{_fmt_ms(dev[True])}, fan-out {_fmt_ms(dev[False])}")
    log(f"[A/B] {n_live} rows in one flush: fused {n_fused} "
        f"launch, fan-out {n_fanout} launches (pinned "
        f"{mechanisms.AB_FANOUT_LAUNCHES}); ms per flush (host clock, "
        f"synchronised, median of 3): fused "
        f"{float(np.median(times[True])):.3f}, fan-out "
        f"{float(np.median(times[False])):.3f}; pools bitwise equal: "
        f"{not bad}")
    log("[A/B] launch counters, fan-out run: " + " ".join(
        f"{k}={launches[k]}" for k in ("fused_dispatch", "fpm_copy",
                                       "fpm_copy_cross", "zero_init"))
        + "; fused run: " + " ".join(
        f"{k}={fused_launches[k]}" for k in ("fused_dispatch", "fpm_copy",
                                             "fpm_copy_cross",
                                             "zero_init")))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"A/B checks failed: {failed} (pools {bad})")
    return launches


def phase_table1(flat):
    """Phase 8a: Table 1 on a phase-6 pool."""
    from repro_torch.launch import mechanisms
    for m in (8, MAX_REQUESTS):
        for r in mechanisms.run(pool=flat, m=m):
            log("[table1] " + json.dumps(r))


def phase_fig2(cfg, params):
    """Phase 8b: Fig. 2 at full width, RowClone off and on."""
    from repro_torch.launch import applications
    rows = applications.run(cfg, params, device="cuda")
    for r in rows:
        log("[fig2] " + json.dumps(r))
    by = {(r["app"], r["rowclone"]): r for r in rows}
    checks = {
        "forkbench: on moves by FPM what off moves through compute":
            by[("forkbench", "on")]["bytes_dma"]
            == by[("forkbench", "off")]["bytes_compute"] > 0,
        "forkbench: 30 tokens": by[("forkbench", "on")]["tokens"] == 30,
        "buz-init: 24 blocks lazily zeroed on, materialised off":
            by[("buz-init", "on")]["zero_lazy"] == 24
            and by[("buz-init", "off")]["zero_mat"] == 24,
        "migrate: on moves by PSM what off moves through compute":
            by[("migrate", "on")]["bytes_ici"]
            == by[("migrate", "off")]["bytes_compute"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"Fig-2 checks failed: {failed}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernels = [phase_k1(scrub), phase_k2(scrub), phase_k3(scrub)]
    torch.cuda.empty_cache()
    launches, cfg, params = phase_serve()
    torch.cuda.empty_cache()
    copy_kernels, flat = phase_copy_kernels(scrub)
    del scrub
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in phase_ab(flat).items()
                     if k in ("fpm_copy", "fpm_copy_cross", "zero_init")})
    phase_table1(flat)
    del flat
    torch.cuda.empty_cache()
    phase_fig2(cfg, params)
    kernels += copy_kernels
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
