"""The autotuner: sweep the engine's throughput constants and persist the
winners as a per-backend ``TunedProfile`` (port of
``benchmarks/bench_autotune.py``; card timing lives in the port's
``launch/``, not in ``benchmarks/``).

* **flush matrix** — the bucket set over mixed copy + zero flushes at
  several batch sizes (``bench_dispatch.py``'s workload shape), scored by
  the mean of the per-batch median ``us_per_flush``, with the launches per
  flush counted under every configuration;
* **ring sweep** — staging-ring capacities over short serving runs
  (admissions and decode rounds through the real ``ServingEngine``),
  scored by the median ``us_per_round``.

Winners are chosen by :func:`~repro_torch.obs.autotune.pick_winner` (a
candidate unseats the default only by a 3% margin) and saved as
``<out_dir>/<backend>.json``.  The candidates, batches, reps and margin are
the reference's.  Two of the reference's axes are not swept, and the
profile's ``swept`` says so: ``overlap`` (K1 has no overlapped-DMA
toggle, so the profile keeps the default ``True``) and
``max_delta_signatures`` (it bounds the reference's jit cache, and the
port's sharded drain compiles nothing per plan).

Every timed flush or round synchronizes the card before the clock stops,
so a time covers the device work, not only the host's enqueue.

CLI: ``PYTHONPATH=src python -m repro_torch.launch.autotune [--out-dir DIR]
[--quick] [--skip-ring] [--check] [--device cpu]``
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cmdqueue
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.autotune import (DEFAULT_MARGIN, TunedProfile,
                                      backend_key, load_profile, pick_winner,
                                      save_profile)
from repro_torch.weights import resolve_device

BLOCK = (16, 2, 64)          # page x KVH x head_dim (bench_dispatch shape)
NBLK = 1024
NSLABS = 4

#: bucket-set candidates (first = the hand-picked default)
BUCKET_SETS: Tuple[Tuple[int, ...], ...] = (
    cmdqueue.DEFAULT_BUCKETS,
    (4, 16, 64, 256),
    (16, 64, 256, 1024),
    (8, 64, 512),
)
BATCHES = (4, 16, 64, 256)
REPS = 15

#: staging-ring candidates (None = the serving layer's policy derivation)
RING_CANDIDATES: Tuple[Optional[int], ...] = (None, 4, 8, 16)
RING_ROUNDS = 6
RING_ADMITS = 3

#: what the profile's ``swept`` records of the axes the port leaves out
NOT_SWEPT = {
    "overlap": "not swept: K1 has no overlapped-DMA toggle (its waves "
               "take the place of the TPU's depth-2 drain); the profile "
               "keeps the default True",
    "delta_signatures": "not swept: the bound caps the reference's jit "
                        "cache; the port's sharded drain compiles nothing "
                        "per plan",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mk_engine(device="cuda") -> RowCloneEngine:
    """The reference's sweep engine: two float32 pools of :data:`NBLK`
    blocks of :data:`BLOCK`, random bytes from seed 0 / 1."""
    device = resolve_device(device)
    alloc = SubarrayAllocator(NBLK, NSLABS, reserved_zero_per_slab=1)
    pools = {name: torch.randn((NBLK,) + BLOCK,
                               generator=torch.Generator().manual_seed(i)
                               ).to(device)
             for i, name in enumerate(("k", "v"))}
    return RowCloneEngine(pools, alloc)


def flush_once(eng: RowCloneEngine, batch: int, round_i: int) -> None:
    """One mixed flush: ~3/4 copies, ~1/4 zero-inits, ids rotating per
    round (``bench_autotune.py _flush_once``, over the engine's own block
    count: at :data:`NBLK` blocks, the reference's rows)."""
    nblk = eng.num_blocks
    n_zero = max(batch // 4, 1)
    n_copy = batch - n_zero
    base = (round_i * batch) % (nblk // 4)
    srcs = [1 + (base + i) % (nblk // 4) for i in range(n_copy)]
    dsts = [nblk // 2 + (base + i) % (nblk // 4) for i in range(n_copy)]
    zeros = [3 * nblk // 4 + (base + i) % (nblk // 8) for i in range(n_zero)]
    eng.alloc.mark_written(srcs)
    with eng.batch():
        eng.memcopy(list(zip(srcs, dsts)))
        eng.materialize_zeros(zeros)


@contextlib.contextmanager
def buckets_installed(buckets: Optional[Sequence[int]]) -> Iterator[None]:
    """Install a bucket set process-wide for the block, and restore
    :data:`~repro_torch.core.cmdqueue.DEFAULT_BUCKETS` after it, whatever
    happens inside."""
    cmdqueue.set_buckets(buckets)
    try:
        yield
    finally:
        cmdqueue.set_buckets(None)


@contextlib.contextmanager
def _raw_configs() -> Iterator[None]:
    """Sweeps measure raw configurations: no profile loads meanwhile."""
    prev = os.environ.get("REPRO_NO_TUNED")
    os.environ["REPRO_NO_TUNED"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_NO_TUNED", None)
        else:
            os.environ["REPRO_NO_TUNED"] = prev


def measure_flush_cfg(buckets: Sequence[int],
                      batches: Sequence[int] = BATCHES, reps: int = REPS,
                      device="cuda",
                      make_engine: Optional[Callable[[], RowCloneEngine]]
                      = None) -> Dict:
    """Score one bucket set: the mean over batch sizes of the median flush
    wall-clock (us, card synchronized), with launch accounting.
    ``make_engine()`` builds each batch's engine (default
    :func:`mk_engine` on ``device``)."""
    if make_engine is None:
        def make_engine():
            return mk_engine(device)
    per_batch: List[float] = []
    launches = 0
    flushes = 0
    with buckets_installed(buckets):
        for batch in batches:
            eng = make_engine()
            for r in range(3):                      # warmup
                flush_once(eng, batch, r)
            times: List[float] = []
            l0 = eng.stats.launches
            for r in range(reps):
                with obs_metrics.Stopwatch() as sw:
                    flush_once(eng, batch, 100 + r)
                    _sync(eng.device)
                times.append(sw.us)
            launches += eng.stats.launches - l0
            flushes += reps
            per_batch.append(obs_metrics.percentile(times, 50))
            del eng           # frees its pools before the next batch's
    return {
        "cfg": {"buckets": list(buckets)},
        "us_per_flush": float(np.mean(per_batch)),
        "us_per_batch": {str(b): round(v, 1)
                         for b, v in zip(batches, per_batch)},
        "launches_per_flush": launches / max(flushes, 1),
    }


def sweep_flush(batches: Sequence[int] = BATCHES, reps: int = REPS,
                bucket_sets: Sequence[Sequence[int]] = BUCKET_SETS,
                device="cuda", make_engine=None) -> List[Dict]:
    """The bucket-set experiment matrix."""
    rows = []
    for buckets in bucket_sets:
        row = measure_flush_cfg(buckets, batches, reps, device, make_engine)
        rows.append(row)
        print(f"  flush buckets={list(buckets)!s:>20}: "
              f"{row['us_per_flush']:>9.1f} us/flush "
              f"({row['launches_per_flush']:.2f} launches)")
    return rows


def measure_ring(ring: Optional[int], rounds: int = RING_ROUNDS,
                 admits: int = RING_ADMITS, device="cuda",
                 model=None) -> Dict:
    """Score one staging-ring capacity over a short serving run (admit a
    prompt in each of the first ``admits`` rounds, decode every round).
    ``model`` defaults to the reduced llama3.2-3b's weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    if model is None:
        model = init_params(get_config("llama3.2-3b").reduced(), 0, device)
    cfg = model.cfg
    eng = ServingEngine(cfg, model, max_seqs=8, max_blocks_per_seq=16,
                        max_admit_pages=ring, adaptive_ring=False,
                        device=model.embed.device)
    rng = np.random.default_rng(0)
    times: List[float] = []
    for r in range(rounds):
        with obs_metrics.Stopwatch() as sw:
            if r < admits:
                eng.add_request(rng.integers(2, cfg.vocab_size, size=24)
                                .astype(np.int32))
            eng.decode_round()
            _sync(eng.device)
        times.append(sw.us)
    meas = times[2:] if len(times) > 2 else times   # drop warmup rounds
    capacity = int(eng.engine.stage_capacity)
    return {
        "cfg": {"ring": ring},
        "us_per_flush": float(obs_metrics.percentile(meas, 50)),
        "stage_capacity": capacity,
    }


def sweep_ring(rounds: int = RING_ROUNDS,
               candidates: Sequence[Optional[int]] = RING_CANDIDATES,
               device="cuda", model=None) -> List[Dict]:
    """:func:`measure_ring` for each staging-ring capacity of
    ``candidates``, printing each row; returns the rows."""
    rows = []
    for ring in candidates:
        row = measure_ring(ring, rounds=rounds, device=device, model=model)
        rows.append(row)
        print(f"  ring={str(ring):>6}: {row['us_per_flush']:>10.1f} "
              f"us/round ({row['stage_capacity']} slots)")
    return rows


def tune(out_dir: Optional[str] = None, quick: bool = False,
         skip_ring: bool = False, device="cuda", make_engine=None,
         model=None) -> TunedProfile:
    """Run the sweeps, pick winners (margin rule), save the profile into
    ``out_dir`` (default ``configs/tuned/``) and load it back.  Returns
    the saved :class:`TunedProfile`.  ``make_engine`` builds the flush
    matrix's engines and ``model`` is the ring sweep's (the defaults: the
    reference's)."""
    device = resolve_device(device)
    with _raw_configs():
        backend = backend_key(device)
        batches = (4, 32) if quick else BATCHES
        reps = 5 if quick else REPS
        bucket_sets = BUCKET_SETS[:2] if quick else BUCKET_SETS
        print(f"[autotune] backend={backend} flush matrix "
              f"({len(bucket_sets)} bucket sets)")
        flush_rows = sweep_flush(batches, reps, bucket_sets, device,
                                 make_engine)
        default_cfg = {"buckets": list(cmdqueue.DEFAULT_BUCKETS)}
        flush_win = pick_winner(flush_rows, default_cfg)
        flush_default = next(r for r in flush_rows
                             if r["cfg"] == default_cfg)
        swept: Dict = {
            "flush": {"rows": flush_rows, "winner": flush_win["cfg"],
                      "margin": DEFAULT_MARGIN,
                      "overlap": NOT_SWEPT["overlap"]},
            "delta_signatures": {"rows": [],
                                 "note": NOT_SWEPT["delta_signatures"]},
        }
        ring: Optional[int] = None
        if not skip_ring:
            print("[autotune] staging-ring sweep")
            ring_rows = sweep_ring(4 if quick else RING_ROUNDS,
                                   RING_CANDIDATES, device, model)
            ring_win = pick_winner(ring_rows, {"ring": None})
            ring = ring_win["cfg"]["ring"]
            swept["ring"] = {"rows": ring_rows, "winner": ring_win["cfg"]}
        profile = TunedProfile(
            backend=backend,
            buckets=tuple(flush_win["cfg"]["buckets"]),
            ring_capacity=ring,
            us_per_flush=float(flush_win["us_per_flush"]),
            baseline_us_per_flush=float(flush_default["us_per_flush"]),
            swept=swept)
    path = save_profile(profile, directory=out_dir)
    print(f"[autotune] wrote {path}")
    loaded = load_profile(backend, directory=out_dir)
    assert loaded is not None and loaded.backend == profile.backend
    return profile


def check(margin: float = 1.15, quick: bool = True, device="cuda") -> int:
    """The gate of a committed profile: it must not be slower than the
    built-in defaults by more than ``margin`` on the flush workload (the
    full tune's batch mix; ``quick`` only drops reps).  0 when no profile
    exists for the backend."""
    device = resolve_device(device)
    prof = load_profile(backend_key(device))
    if prof is None:
        print("[autotune] no committed profile for backend "
              f"{backend_key(device)!r}: nothing to check")
        return 0
    reps = 5 if quick else REPS
    with _raw_configs():
        default_row = measure_flush_cfg(cmdqueue.DEFAULT_BUCKETS, BATCHES,
                                        reps, device)
        tuned_row = measure_flush_cfg(prof.buckets, BATCHES, reps, device)
    d, t = default_row["us_per_flush"], tuned_row["us_per_flush"]
    print(f"[autotune] check: defaults {d:.1f} us/flush, tuned profile "
          f"{t:.1f} us/flush ({t / d:.2f}x)")
    if t > d * margin:
        print(f"FAIL: the tuned profile is {t / d:.2f}x slower than the "
              f"defaults (> {margin:.2f}x): retune or delete "
              f"configs/tuned/{prof.backend}.json")
        return 1
    print("autotune check OK: the profile does not regress the defaults")
    return 0


def main(argv=None) -> int:
    """CLI: sweep and persist (default), or the ``--check`` gate."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="profile directory (default $REPRO_TUNED_DIR, else "
                         "the checkout's configs/tuned/: on the card that "
                         "writes configs/tuned/cuda.json, which the engines "
                         "then load; commit it only with a measured cell "
                         "behind it)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny matrix and reps")
    ap.add_argument("--skip-ring", action="store_true",
                    help="skip the serving staging-ring sweep")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the profile regresses the defaults")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.check:
        return check(device=args.device)
    prof = tune(out_dir=args.out_dir, quick=args.quick,
                skip_ring=args.skip_ring, device=args.device)
    print(f"[autotune] winner: buckets={list(prof.buckets)} "
          f"ring={prof.ring_capacity} ({prof.us_per_flush:.1f} us/flush vs "
          f"{prof.baseline_us_per_flush:.1f} default)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
