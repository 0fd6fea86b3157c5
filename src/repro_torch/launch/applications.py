"""Fig. 2 on the card: the application-level effect of RowClone(-ZI), port
of ``benchmarks/fig2_applications.py``, each application run with
RowClone off and on:

  forkbench   admit a 48-token prompt, fork it into 4, decode 6 rounds
              (CoW-heavy: the paper's fork microbenchmark)
  buz-init    admit 24 sequences of 64 tokens without prefill; with
              RowClone off every fresh block is zeroed (shell / boot-up
              zeroing)
  migrate     home 4 sequences on slab 0, then rebalance the slabs with
              :mod:`repro_torch.core.migration` (page migration)
  checkpoint  train yi-6b reduced for 12 steps with a checkpoint every 3
              (``launch/train.py train_loop``): off writes each checkpoint
              before the next step, on writes it on a background thread
              (the paper's process checkpointing)

The first three run through the port's ServingEngine, off with baseline
copies and materialised zeros, on with FPM + PSM + ZI.  Each row carries
the JAX rows' stats fields and ``wall_s``, the host clock around the
application after ``torch.cuda.synchronize()`` on the card; a third row
per application is the off / on wall-clock ratio.

CLI:  PYTHONPATH=src python -m repro_torch.launch.applications --smoke \\
          --device cpu
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig, RowCloneConfig, get_config
from repro_torch.core.migration import execute as migrate_execute
from repro_torch.core.migration import plan_rebalance
from repro_torch.launch.serve import ServingEngine
from repro_torch.launch.train import train_loop
from repro_torch.models.lm import LanguageModel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.weights import init_params, resolve_device


def _engine(cfg: ModelConfig, params: LanguageModel, on: bool,
            device: torch.device, max_seqs: int = 16) -> ServingEngine:
    rc = RowCloneConfig(enable_fpm=on, enable_psm=on, enable_zi=on)
    return ServingEngine(cfg, params, max_seqs=max_seqs, rc=rc,
                         device=device)


def _timed(fn: Callable[[], None], device: torch.device) -> float:
    """Seconds of ``fn()`` on the host clock, synchronised on the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = obs_metrics.now()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return obs_metrics.now() - t0


def forkbench(cfg, params, on: bool, device) -> Dict:
    """Fig. 2's fork benchmark: admit a 48-token prompt, fork it into
    4 and decode 6 rounds; the bytes moved through compute, by FPM and
    avoided, and the tokens."""
    eng = _engine(cfg, params, on, device)
    rng = np.random.default_rng(0)

    def app():
        sid = eng.add_request(rng.integers(2, cfg.vocab_size,
                                           size=48).astype(np.int32))
        eng.fork(sid, 4)
        for _ in range(6):
            eng.decode_round()

    dt = _timed(app, device)
    s = eng.engine.stats
    return dict(wall_s=dt, bytes_compute=s.bytes_baseline,
                bytes_dma=s.bytes_fpm, bytes_avoided=s.bytes_avoided,
                tokens=6 * len(eng.cache.seqs))


def buz_init(cfg, params, on: bool, device) -> Dict:
    """Fig. 2's bulk zeroing: 24 fresh 64-token sequences, lazily zeroed
    (ZI) when ``on``, else every block materialised; the blocks and
    the zeroing counts."""
    eng = _engine(cfg, params, on, device, max_seqs=32)
    sids: List[int] = []

    def app():
        for _ in range(24):
            sids.append(eng.cache.new_sequence(prompt_len=64))
        if not on:
            # without ZI every fresh block is physically zeroed
            pend = eng.engine.alloc.pending_zero(
                [b for s in sids for b in eng.cache.blocks_of(s)])
            eng.engine.materialize_zeros(pend)

    dt = _timed(app, device)
    s = eng.engine.stats
    nblk = sum(len(eng.cache.blocks_of(s_)) for s_ in sids)
    return dict(wall_s=dt, blocks=nblk, bytes_avoided=s.bytes_avoided,
                zero_lazy=s.zero_lazy, zero_mat=s.zero_materialized)


def migrate(cfg, params, on: bool, device) -> Dict:
    """Fig. 2's page migration: four 64-token sequences homed on slab 0
    rebalanced over the slabs (``core/migration.py``); the blocks moved
    and the bytes moved by PSM or through compute."""
    eng = _engine(cfg, params, on, device)
    for _ in range(4):
        sid = eng.cache.new_sequence(prompt_len=64, prefer_slab=0)
        eng.engine.alloc.mark_written(eng.cache.blocks_of(sid))
    out: Dict[str, int] = {}

    def app():
        plan = plan_rebalance(eng.cache)
        out.update(migrate_execute(plan, eng.cache, chunk_blocks=8))

    dt = _timed(app, device)
    return dict(wall_s=dt, moved=out["moved_blocks"],
                bytes_ici=eng.engine.stats.bytes_psm,
                bytes_compute=eng.engine.stats.bytes_baseline)


def checkpoint(cfg, params, on: bool, device) -> Dict:
    """Training with a checkpoint every 3 steps into a temporary
    directory (removed after): asynchronous writes on, blocking off.  It
    trains its own model (yi-6b reduced, as the reference), not
    ``cfg`` / ``params``."""
    d = tempfile.mkdtemp()
    try:
        dt = _timed(lambda: train_loop(
            "yi-6b", steps=12, batch=2, seq_len=64, smoke=True, ckpt_dir=d,
            checkpoint_every=3, log_every=100, device=device,
            async_save=on), device)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(wall_s=dt, checkpoints=4)


APPS = (("forkbench", forkbench), ("buz-init", buz_init),
        ("migrate", migrate), ("checkpoint", checkpoint))


def run(cfg: Optional[ModelConfig] = None,
        params: Optional[LanguageModel] = None, *, device="cuda",
        seed: int = 0) -> List[Dict]:
    """Every application, RowClone off then on, then the ratio row.
    ``cfg`` defaults to llama3.2-3b at full width and ``params`` to its
    random weights from ``seed`` on ``device``.  Each engine is freed
    before the next one is built."""
    device = resolve_device(device)
    cfg = cfg or get_config("llama3.2-3b")
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    rows = []
    for name, fn in APPS:
        res = {}
        for mode, on in (("off", False), ("on", True)):
            res[mode] = fn(cfg, params, on, device)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            rows.append(dict(app=name, rowclone=mode, **res[mode]))
        rows.append(dict(app=name, rowclone="speedup",
                         wall_s=res["off"]["wall_s"]
                         / max(res["on"]["wall_s"], 1e-9)))
    return rows


def main() -> None:
    """CLI: print the Fig-2 rows as JSON lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced (CPU-sized) configuration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    for row in run(cfg, device=args.device, seed=args.seed):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
