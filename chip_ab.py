#!/usr/bin/env python3
"""Time one checkout of the PyTorch port on one NVIDIA GPU, so that two
checkouts (a parent and a change) can be compared on one card.

    python3 chip_ab.py --src DIR --tag NAME [--rows k2,k4,k3,k5,k7,k1,e2e,bits]

Imports ``repro_torch`` from ``DIR`` (a checkout's ``src``), builds its
kernels and prints one JSON line, every time through ``chip_smoke.py``'s
own helpers (``time_ms``: CUDA events around one call, the L2 scrubbed
before each; ``device_ms``: the profiler's device time of the call):

- ``k2``: paged decode attention through ``ops.paged_attention_slab`` on
  phase 2's serving slab at llama3.2-3b's heads (B=8, H=24, KVH=8,
  D=128) and zamba2-2.7b's (B=4, H=KVH=32, D=80): card ms and device ms;
- ``k4``: the SSD intra-chunk term through ``ops.ssd_intra_chunk`` at
  mamba2-780m's and zamba2-2.7b's batch prefill (8 chunk rows of 256,
  bf16): card ms and device ms;
- ``k3``: prefill attention through ``ops.flash_attention`` at
  llama3.2-3b's heads (B=1, H=24, KVH=8, D=128, S=512) and zamba2-2.7b's
  batch prefill (B=4, H=KVH=32, D=80, S=384), causal: card ms, device ms
  and the SDPA call's card ms;
- ``k5``: K5a, K5b and K6 at phase 6's axis-0 pools, m = 8 and 256
  (with their padding and write-after-read pair): card ms, device ms and
  the library call's card ms;
- ``k7``: the PSM transfer through ``ops.psm_transfer`` on phase 20
  (a)'s calls (llama3.2-3b blocks, 4 and 8 ranks on the card, the same
  seeds) and Table 1's ``copy-psm`` (``ops.psm_copy`` at m = 8 and 256 on
  a phase-6 axis-0 pool): card ms, device ms and, for K7 alone, the
  host us a call (``chip_smoke.host_call_us``: the least of three
  batches of 20 calls);
- ``k1``: the fused drain on phase 2's serving table through
  ``ops.fused_dispatch`` (layer-stacked pools) and on phase 7's 419-row
  flush through one ``RowCloneEngine._drain_rows`` (flat pools): card ms,
  K1's device ms, the device busy ms of the call, and the host clock
  (synchronised, median of 3);
- ``e2e``: llama3.2-3b admitting chip_smoke's four prompts into a fresh
  serving engine, one steady serving round of those four and a fork, and
  zamba2-2.7b's batch prefill at full width (random weights, seed 0): the
  host clock (synchronised, median of 3) and the device ms of one call
  (busy, and K2's, K3's, K4's and the copy kernels' share).

The row ``bits`` (not in the default list) times nothing: it runs K3 and
K2 at head dims 80, 128, 256 and 64 (zamba2-2.7b's 32 / 32 heads,
llama3.2-3b's 24 / 8, yi-6b's 32 / 4, deepseek-moe-16b's 16 / 16,
paligemma-3b's 8 / 1 and seamless-m4t-medium's 16 / 16; K3 causal with
prefixes 0, 100 and 256 at ragged S, and at D = 64 also non-causal with
Sq != Skv; K2 on a ragged slab with a shared block) on inputs drawn from
a fixed seed, and prints the SHA-256 of each output's bytes, so that two
checkouts' lines show whether a kernel change left those head dims'
results bit for bit as they were.  A case the checkout's wrapper refuses
prints ``refused``.

Run it on the two checkouts in turns (parent, change, change, parent)
on one machine in one go: two separate runs may land on two cards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--rows", default="k2,k4,k3,k5,k7,k1,e2e",
                    help="comma-separated rows (default: every timed row; "
                         "bits only when named)")
    return ap.parse_args()


#: the ``bits`` row's cases: (D, H, KVH, K3 cases (B, Sq, Skv, causal,
#: prefix_len)); the head dims in the order they came, so that a case's
#: inputs stay the same draws when a head dim is added after it
BITS_CASES = (
    (80, 32, 32, ((4, 384, 384, True, 0), (1, 250, 250, True, 100),
                  (1, 65, 65, True, 0))),
    (128, 24, 8, ((1, 512, 512, True, 0), (1, 250, 250, True, 0),
                  (2, 300, 300, True, 100))),
    (128, 32, 4, ((1, 512, 512, True, 0),)),
    (128, 16, 16, ((1, 250, 250, True, 0),)),
    (256, 8, 1, ((4, 384, 384, True, 256), (1, 313, 313, True, 0))),
    (64, 16, 16, ((4, 512, 512, True, 0), (1, 57, 57, True, 0),
                  (1, 14, 14, False, 0), (4, 512, 128, False, 0),
                  (1, 57, 14, False, 0), (4, 1, 128, False, 0))))


def bits(torch, ops, scrub) -> dict:
    """SHA-256 (first 16 hex digits) of K3's and K2's outputs on seeded
    inputs, by case of :data:`BITS_CASES`; ``refused`` where the
    checkout's wrapper raises ``ValueError`` (a head dim or shape it does
    not take)."""
    import hashlib
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def digest(t):
        raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        return hashlib.sha256(raw).hexdigest()[:16]

    def held(key, call):
        try:
            out[key] = digest(call())
        except ValueError:
            out[key] = "refused"

    for D, H, KVH, cases in BITS_CASES:
        for B, Sq, Skv, causal, prefix in cases:
            q = rnd(B, Sq, H, D).transpose(1, 2)
            k, v = (rnd(B, Skv, KVH, D).transpose(1, 2) for _ in range(2))
            shape = f"S={Sq}" if Sq == Skv else f"Sq={Sq} Skv={Skv}"
            kind = f"prefix={prefix}" if causal else "non-causal"
            held(f"k3 D={D} H={H} KVH={KVH} B={B} {shape} {kind}",
                 lambda: ops.flash_attention(q, k, v, causal=causal,
                                             prefix_len=prefix,
                                             use_kernel=True))
        nblk, page, lens = 64, 64, (700, 64, 1, 130, 0, 333)
        mask = np.zeros((nblk, len(lens)), np.int8)
        base = np.zeros(nblk, np.int32)
        blocks = iter(np.random.default_rng(D + H).permutation(nblk))
        first = None
        for b, n in enumerate(lens):
            for j in range(-(-n // page)):
                blk = next(blocks)
                first = blk if first is None else first
                mask[blk, b], base[blk] = 1, j * page
        mask[first, 1] = 1                 # a block shared by two readers
        args = (rnd(len(lens), H, D), rnd(nblk, page, KVH, D),
                rnd(nblk, page, KVH, D), torch.from_numpy(mask).cuda(),
                torch.from_numpy(base).cuda(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        try:
            got = ops.paged_attention_slab(*args, page=page, use_kernel=True)
        except ValueError:
            got = (None,) * 3
        for name, t in zip(("acc", "l", "m"), got):
            out[f"k2 D={D} H={H} KVH={KVH} {name}"] = \
                "refused" if t is None else digest(t)
    return out


def k3(torch, ops, scrub) -> dict:
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {}
    for B, H, KVH, S, D in ((1, 24, 8, 512, 128), (4, 32, 32, 384, 80)):
        q, k, v = (torch.randn((B, h, S, D), generator=gen, device="cuda")
                   .bfloat16() for h in (H, KVH, KVH))

        def kern():
            return ops.flash_attention(q, k, v, causal=True, use_kernel=True)

        out[f"B{B}_S{S}_D{D}"] = dict(
            ms=cs.time_ms(kern, scrub=scrub),
            device_ms=cs.device_ms(kern, key="flash_kernel"),
            sdpa_ms=cs.time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), scrub=scrub))
    return out


def k2(torch, ops, scrub) -> dict:
    page, nblk = 64, cs.MAX_SEQS * cs.MAX_BLOCKS_PER_SEQ
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    out = {}
    for B, H, KVH, D in ((cs.MAX_SEQS, 24, 8, 128), (cs.SSM_BATCH, 32, 32,
                                                      80)):
        q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((nblk, page, KVH, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        tables = cs._k2_layout(np.random.default_rng(cs.SEED), nblk, B, page,
                               "serve")
        args = (q, k, v) + tuple(torch.from_numpy(a).cuda() for a in tables)

        def kern():
            return ops.paged_attention_slab(*args, page=page,
                                            use_kernel=True)

        out[f"B{B}_H{H}_D{D}"] = dict(
            ms=cs.time_ms(kern, scrub=scrub),
            device_ms=cs.device_ms(kern, key="paged_attn"))
    return out


def k4(torch, ops, scrub) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    out = {}
    for arch, Bc, Q, H, N in cs.K4_CASES[:2]:
        args = cs._ssd_inputs(gen, Bc, Q, H, N)

        def kern():
            return ops.ssd_intra_chunk(*args, use_kernel=True)

        out[arch] = dict(ms=cs.time_ms(kern, scrub=scrub),
                         device_ms=cs.device_ms(kern, key="ssd_intra"))
    return out


def k5(torch, ops, scrub) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    shape = (cs.FLAT_NBLK, 64, 8, 128)
    pool, other = cs._bf16_pool(shape, gen), cs._bf16_pool(shape, gen)
    out = {}
    for m in (8, cs.MAX_REQUESTS):
        rng = np.random.default_rng(cs.SEED + 3)
        ids = cs._copy_ids(rng, cs.FLAT_NBLK, m)
        xids = cs._copy_ids(rng, cs.FLAT_NBLK, m, n_src=cs.FLAT_NBLK)
        zids = ids[:, 1].copy()
        live, xlive = ids[ids[:, 1] >= 0], xids[xids[:, 1] >= 0]
        t_src, t_dst, x_src, x_dst = (
            torch.from_numpy(a[:, i].astype(np.int64)).cuda()
            for a, i in ((live, 0), (live, 1), (xlive, 0), (xlive, 1)))
        calls = {
            "fpm_copy": (
                lambda: ops.fpm_copy(pool, ids, use_kernel=True),
                lambda: pool.index_copy_(0, t_dst,
                                         pool.index_select(0, t_src))),
            "fpm_copy_cross": (
                lambda: ops.fpm_copy_cross(pool, other, xids,
                                           use_kernel=True),
                lambda: pool.index_copy_(0, x_dst,
                                         other.index_select(0, x_src))),
            "zero_init": (lambda: ops.meminit_zero(pool, zids,
                                                   use_kernel=True),
                          lambda: pool.index_fill_(0, t_dst, 0)),
        }
        for name, (fn, lib) in calls.items():
            out[f"{name}_m{m}"] = dict(
                ms=cs.time_ms(fn, scrub=scrub),
                device_ms=cs.device_ms(fn, key="move_kernel"),
                library_ms=cs.time_ms(lib, scrub=scrub))
    return out


def k7(torch, ops, scrub) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    rng = np.random.default_rng(cs.SEED + 20)
    out = {}
    for n in (4, 8):
        slabs, ids = cs._k7_case(gen, rng, n)

        def run():
            ops.psm_transfer(slabs, ids, block_axis=1)

        out[f"n{n}"] = dict(
            rows=int((ids[:, :, 0] >= 0).sum()),
            ms=cs.time_ms(run, scrub=scrub),
            device_ms=cs.device_ms(run, key="psm_kernel", reps=10),
            host_us=cs.host_call_us(run))
        del slabs
        torch.cuda.empty_cache()
    pool = cs._bf16_pool((cs.FLAT_NBLK, 64, 8, 128), gen)
    half = cs.FLAT_NBLK // 2
    for m in (8, cs.MAX_REQUESTS):
        ids = np.asarray([[i, half + i] for i in range(m)], np.int32)
        fn = lambda: ops.psm_copy(pool, ids)
        out[f"copy_psm_m{m}"] = dict(
            ms=cs.time_ms(fn, scrub=scrub),
            device_ms=cs.device_ms(fn, key="psm_kernel"))
    return out


def _k1_reading(torch, fn, scrub) -> dict:
    """Card ms, K1's device ms, the call's device busy ms and its host ms
    (synchronised, median of 3 after a warm call) of ``fn``."""
    def host():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    host()
    return dict(ms=cs.time_ms(fn, scrub=scrub),
                device_ms=cs.device_ms(fn, key="drain_kernel"),
                busy_ms=cs.device_ms(fn),
                host_ms=float(np.median([host() for _ in range(3)])))


def k1(torch, ops, scrub) -> dict:
    from repro_torch.launch import mechanisms
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    pools, zero_blocks, table, primary = cs.k1_serving_case(gen)
    out = {"serving": _k1_reading(torch, lambda: ops.fused_dispatch(
        pools, zero_blocks, table, block_axis=1, primary=primary,
        use_kernel=True), scrub)}
    del pools
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    shape = (cs.FLAT_NBLK, 64, 8, 128)
    k, v = cs._bf16_pool(shape, gen), cs._bf16_pool(shape, gen)
    stage = [cs._bf16_pool((64,) + shape[1:], gen) for _ in range(2)]
    eng = cs.ab_engine(k, v, stage, True)
    del k, v
    mechanisms.drive(eng, mechanisms.ab_program(cs.FLAT_NBLK))
    rows = eng.journal.records[-1].rows
    out["ab_flush"] = _k1_reading(torch, lambda: eng._drain_rows(rows),
                                  scrub)
    out["ab_flush"]["rows"] = sum(1 for r in rows if r[0] >= 0)
    del eng
    torch.cuda.empty_cache()
    return out


def _host_and_device(torch, run, setup=lambda: None) -> dict:
    """Host ms of ``run(setup())`` (synchronised, median of 3 after a warm
    call; ``setup`` untimed) and the device ms of one call (``device_ms``
    after its warm call): busy, K2's, K3's and K4's kernels, copy
    kernels."""
    def timed():
        x = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed()
    out = {"host_ms": float(np.median([timed() for _ in range(3)]))}
    for name, key in (("busy", ""), ("k2", "paged_attn"),
                      ("k3", "flash_kernel"), ("k4", "ssd_intra"),
                      ("copies", "direct_copy")):
        x = setup()
        out[f"{name}_ms"] = cs.device_ms(lambda: run(x), key=key, reps=1)
        del x
    return out


def e2e(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    rng = np.random.default_rng(cs.SEED)
    cfg = get_config("llama3.2-3b")
    params = init_params(cfg, seed=cs.SEED, device="cuda")
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in cs.PROMPT_LENS]
    # the four admissions into a fresh engine (which holds twice as many
    # sequences: device_ms admits them twice)
    res = {"llama_admission": _host_and_device(
        torch, lambda eng: cs._admit_all(eng, prompts),
        setup=lambda: ServingEngine(
            cfg, params, max_seqs=cs.MAX_SEQS,
            max_blocks_per_seq=cs.MAX_BLOCKS_PER_SEQ))}
    torch.cuda.empty_cache()
    # a steady round: the four prompts and a fork of the first, as phase 5
    eng = ServingEngine(cfg, params, max_seqs=cs.MAX_SEQS,
                        max_blocks_per_seq=cs.MAX_BLOCKS_PER_SEQ)
    sids = cs._admit_all(eng, prompts)
    eng.decode_round()
    eng.fork(sids[0], 2)
    for _ in range(2):
        eng.decode_round()
    res["llama_round"] = _host_and_device(torch,
                                          lambda _: eng.decode_round())
    del eng, params
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-2.7b")
    model = init_params(cfg, seed=cs.SEED, device="cuda")
    batch = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (cs.SSM_BATCH, cs.SSM_PROMPT))).cuda()
    res["zamba2_prefill"] = _host_and_device(
        torch, lambda _: model.prefill_state(batch))
    del model
    torch.cuda.empty_cache()
    return res


def main() -> int:
    args = _args()
    # ahead of chip_smoke's own src: the package under test
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops
    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = args.rows.split(",")
    out = {"tag": args.tag, "src": args.src, "smi": smi.stdout.strip()}
    for name, row in (("k2", k2), ("k4", k4), ("k3", k3), ("k5", k5),
                      ("k7", k7), ("k1", k1), ("bits", bits)):
        if name in rows:
            out[name] = row(torch, ops, scrub)
    del scrub
    torch.cuda.empty_cache()
    if "e2e" in rows:
        out["e2e"] = e2e(torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
