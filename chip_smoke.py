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

The last two lines are the ``kernels`` JSON and the device JSON.
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
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if scrub is not None:
            scrub.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


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
    return launches


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
    del scrub
    torch.cuda.empty_cache()
    launches = phase_serve()
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
