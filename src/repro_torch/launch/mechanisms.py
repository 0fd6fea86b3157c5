"""Table 1 on the card: the time of each copy / zero mechanism on one
block list (port of ``benchmarks/table1_mechanisms.py run()``), and the
fixed op script that holds the fused drain against the per-mechanism
fan-out.

One "row" is one KV block (64 tokens x 8 KV heads x 128 dims).  Rows:

  copy-baseline  blocks round-trip float32 arithmetic (the copy through
                 the compute units, ``ops.baseline_copy``)
  copy-fpm       K5a, a pure byte move (``ops.fpm_copy``)
  copy-zi-alias  the RowClone-ZI in-cache copy of a lazily zero block: a
                 metadata move, host time per block
  copy-psm       the fan-out's cross-slab copy: K7 with one rank and hop
                 0 (``ops.psm_copy``, one launch per wave of the ids);
                 the JAX row timed ``baseline_copy`` as a CPU stand-in
  zero-baseline  zeros made and scattered by tensor code
  zero-buz       K6 (``ops.meminit_zero``)
  zero-zi        the lazy-zero bit, host time per block

Columns: ``measured_ms`` (median over ``reps`` calls, CUDA events with the
L2 cache scrubbed before each call on the card, the host clock on the
CPU), ``bound_ms`` (bytes moved / 3.35 TB/s, the H100's memory rate; None
off the card), ``speedup_x`` (the baseline's time over the row's), and the
byte columns of the JAX rows, ``bytes_compute`` and ``bytes_ici``.  The
JAX rows' TPU v5e path model (derived latency and energy) describes a TPU
and is not carried over.

CLI:  PYTHONPATH=src python -m repro_torch.launch.mechanisms --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.poolspec import BlockRef
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.kernels import ops as kops
from repro_torch.kernels.cost import HBM_BYTES_PER_S
from repro_torch.obs import metrics as obs_metrics
from repro_torch.weights import resolve_device

#: one KV block: page x KV heads x head_dim
BLOCK = (64, 8, 128)
#: bytes of the L2-scrub buffer (the H100's L2 is 50 MB)
SCRUB_BYTES = 64 * 2 ** 20


def time_ms(fn: Callable[[], object], device: torch.device, reps: int = 20,
            scrub: Optional[torch.Tensor] = None) -> float:
    """Median ms of one ``fn()`` after two warm-up calls: CUDA events on
    the card (``scrub`` rewritten before each call, so the call finds the
    L2 cold), the host clock on the CPU."""
    for _ in range(2):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            if scrub is not None:
                scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = obs_metrics.now()
            fn()
            times.append((obs_metrics.now() - t0) * 1e3)
    return float(np.median(times))


def _host_ms_per_block(fn: Callable[[], object], m: int) -> float:
    t0 = obs_metrics.now()
    fn()
    return (obs_metrics.now() - t0) * 1e3 / m


def run(device="cuda", nblk: int = 64, m: int = 8, *,
        pool: Optional[torch.Tensor] = None, reps: int = 20) -> List[Dict]:
    """The seven Table-1 rows for ``m`` blocks per call on a float32 flat
    pool ``(nblk, 64, 8, 128)`` of random values from seed 0 (or on
    ``pool``, whose first axis indexes blocks, on its device): sources
    ``0..m-1``, destinations and zeroed blocks from ``nblk // 2``."""
    if pool is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(0)
        pool = torch.randn((nblk,) + BLOCK, generator=gen, device=device)
    device = pool.device
    nblk = int(pool.shape[0])
    if not 0 < m <= nblk // 2 or nblk % 4:
        raise ValueError(f"m={m} blocks per call on a pool of {nblk}")
    block_bytes = int(np.prod(pool.shape[1:])) * pool.element_size()
    half = nblk // 2
    ids = np.asarray([[i, half + i] for i in range(m)], np.int32)
    zids = np.arange(half, half + m, dtype=np.int32)
    zids_t = torch.from_numpy(zids.astype(np.int64)).to(device)
    scrub = (torch.empty(SCRUB_BYTES, dtype=torch.uint8, device=device)
             if device.type == "cuda" else None)

    def timed(fn):
        return time_ms(fn, device, reps=reps, scrub=scrub)

    def zero_baseline():
        zeros = torch.zeros((m,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                            device=device)
        pool.index_copy_(0, zids_t, zeros)

    # the ZI rows run through an engine over the same pool
    alloc = SubarrayAllocator(nblk, 4)
    eng = RowCloneEngine({"k": pool}, alloc, max_requests=16)
    srcs = alloc.alloc(m, prefer_slab=0)
    eng.meminit(srcs)                 # lazily zero: the copies alias
    dsts = alloc.alloc(m, prefer_slab=0)
    fresh = alloc.alloc(m, prefer_slab=1)

    copy_b, zero_b = 2 * m * block_bytes, m * block_bytes
    rows = [
        dict(mech="copy-baseline", bytes_moved=copy_b,
             bytes_compute=copy_b, bytes_ici=0,
             measured_ms=timed(lambda: kops.baseline_copy(pool, ids))),
        dict(mech="copy-fpm", bytes_moved=copy_b, bytes_compute=0,
             bytes_ici=0,
             measured_ms=timed(lambda: kops.fpm_copy(pool, ids))),
        dict(mech="copy-zi-alias", bytes_moved=0, bytes_compute=0,
             bytes_ici=0, measured_ms=_host_ms_per_block(
                 lambda: eng.memcopy(list(zip(srcs, dsts))), m),
             note="host time per block"),
        dict(mech="copy-psm", bytes_moved=copy_b, bytes_compute=0,
             bytes_ici=m * block_bytes,
             measured_ms=timed(lambda: kops.psm_copy(pool, ids)),
             note="one device: K7 with one rank, hop 0"),
        dict(mech="zero-baseline", bytes_moved=zero_b,
             bytes_compute=zero_b, bytes_ici=0,
             measured_ms=timed(zero_baseline)),
        dict(mech="zero-buz", bytes_moved=zero_b, bytes_compute=0,
             bytes_ici=0,
             measured_ms=timed(lambda: kops.meminit_zero(pool, zids))),
        dict(mech="zero-zi", bytes_moved=0, bytes_compute=0, bytes_ici=0,
             measured_ms=_host_ms_per_block(lambda: eng.meminit(fresh), m),
             note="host time per block"),
    ]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    base = {"copy": rows[0]["measured_ms"], "zero": rows[4]["measured_ms"]}
    for r in rows:
        r["device"] = name
        r["m"] = m
        r["bound_ms"] = (r["bytes_moved"] / HBM_BYTES_PER_S * 1e3
                         if device.type == "cuda" else None)
        b = base[r["mech"].split("-")[0]]
        r["speedup_x"] = b / r["measured_ms"] if r["measured_ms"] \
            else float("inf")
    return rows


# ---------------------------------------------------------------------------
# the fused-vs-fan-out A/B script
# ---------------------------------------------------------------------------

#: fan-out launches of one drain of :func:`ab_program` (the JAX fan-out
#: issues the same count; tests/test_torch_fanout.py pins both)
AB_FANOUT_LAUNCHES = 22


#: FPM copies in the A/B script's first run (two chunks at max_requests 256)
AB_FPM_ROWS = 300


def ab_program(nblk: int) -> List[list]:
    """A fixed op script over pools ``k``, ``v`` (``nblk`` blocks, 4 slabs)
    and staging pools ``k_stage``, ``v_stage`` (at least 40 slots), in
    the instruction format of ``tests/test_dispatch_properties.py
    gen_program`` plus ``["flags", {attr: value}]``.  Every mechanism
    appears: a run of :data:`AB_FPM_ROWS` FPM copies carrying a
    write-after-read pair, baseline and PSM copies, BuZ zeros, lazy zeros
    and alias copies, promotions and a demotion across pools, AND/OR/NOT.
    No RAW or WAW pair, so the whole script drains as one flush."""
    n = AB_FPM_ROWS
    S = nblk // 4
    if S < 2 * n + 1:
        raise ValueError(f"ab_program needs {4 * (2 * n + 1)} blocks, got "
                         f"{nblk}")
    fpm = [[1 + i, 1 + n + i] for i in range(n)]
    fpm[n // 2][1] = 1             # WAR: rewrites row 0's source
    return [
        ["copy", fpm],
        ["flags", {"enable_fpm": False}],
        ["copy", [[S + 1 + i, S + 11 + i] for i in range(10)]],
        ["flags", {"enable_fpm": True}],
        ["copy", [[2 * S + 1 + i, 3 * S + 1 + i] for i in range(20)]],
        ["zero", list(range(2 * S + 100, 2 * S + 140))],
        ["lazy", list(range(3 * S + 100, 3 * S + 108))],
        ["copy", [[3 * S + 100 + i, 3 * S + 120 + i] for i in range(8)]],
        ["cross", [[i, 3 * S + 200 + i] for i in range(16)],
         "k_stage", "k"],
        ["cross", [[i, 3 * S + 200 + i] for i in range(16)],
         "v_stage", "v"],
        ["cross", [[S + 300 + i, 32 + i] for i in range(8)], "k", "k_stage"],
        ["bit", "and", [[S + 400 + i, S + 410 + i, S + 420 + i]
                        for i in range(3)], "int"],
        ["bit", "or", [[["k", S + 430], ["v", S + 431], ["v", S + 432]]],
         "ref"],
        ["bit", "not", [[S + 440, S + 441]], "int"],
    ]


def drive(eng, prog: List[list], block_ref=BlockRef) -> None:
    """Run ``prog`` on ``eng`` inside one ``batch()``.  ``block_ref`` is
    the engine package's BlockRef class (the tests drive the JAX engine
    with the same script)."""
    with eng.batch():
        for instr in prog:
            kind = instr[0]
            if kind == "flags":
                for attr, value in instr[1].items():
                    setattr(eng, attr, value)
            elif kind == "copy":
                eng.memcopy([tuple(p) for p in instr[1]])
            elif kind == "zero":
                eng.materialize_zeros(instr[1])
            elif kind == "lazy":
                eng.meminit(instr[1], lazy=True)
            elif kind == "bit":
                op, rows, mode = instr[1], instr[2], instr[3]
                args = ([tuple(r) for r in rows] if mode == "int" else
                        [tuple(block_ref(p, i) for p, i in r) for r in rows])
                getattr(eng, "mem" + op)(args)
            elif kind == "cross":
                sp, dp = instr[2], instr[3]
                eng.memcopy_cross([(block_ref(sp, s), block_ref(dp, d))
                                   for s, d in instr[1]])
            else:
                raise ValueError(f"unknown instruction {kind!r}")


def main() -> None:
    """CLI: print the Table-1 rows as JSON lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nblk", type=int, default=64)
    ap.add_argument("--m", type=int, default=8)
    args = ap.parse_args()
    for row in run(args.device, nblk=args.nblk, m=args.m):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
