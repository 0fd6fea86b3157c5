"""End-to-end training driver of the PyTorch port: ~100M-param
llama-family model, a few hundred steps on the synthetic pipeline, with
checkpointing, straggler ledger, and one injected failure + automatic
restart.

The counterpart of ``examples/train_e2e.py``, over the port's
``launch/train.py train_loop`` (fp32 master weights, bf16 views in the
forward, AdamW):

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300 \\
        [--device cpu]

(Reduce --steps for a quick look.)
"""
import argparse
import copy
import dataclasses
import tempfile
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs import _REGISTRY, get_config
from repro_torch.launch.train import TrainState, train_loop
from repro_torch.models import LanguageModel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import NodeFailure
from repro_torch.weights import resolve_device


def register_100m():
    """A ~100M llama-family config (registered once)."""
    if "llama-100m" in _REGISTRY:
        return
    base = get_config("llama3.2-3b")
    cfg = dataclasses.replace(
        base, arch_id="llama-100m", num_layers=8, d_model=640, num_heads=10,
        num_kv_heads=2, head_dim=64, d_ff=1792, vocab_size=32000,
        dtype="float32", tie_embeddings=True)
    _REGISTRY["llama-100m"] = cfg
    n = cfg.param_count()
    print(f"[e2e] registered llama-100m: {n/1e6:.1f}M params")


#: the checkpoint manager's histograms (microseconds) the run reports
CKPT_SERIES = ("ckpt.save_us", "ckpt.write_us", "ckpt.restore_us")


class E2ERun(NamedTuple):
    """What a run leaves: the final state, the losses of the run that
    finished (after a restart, its steps only), whether a failure
    restarted it, the seconds of the failed and the finishing calls (0
    where there was none), and the ms of each checkpoint save (the host
    copy), write and restore by those names."""

    state: TrainState
    losses: List[float]
    restarted: bool
    failed_s: float
    finished_s: float
    ckpt_ms: Dict[str, List[float]]


def train_e2e(steps: int = 300, batch: int = 8, seq_len: int = 512,
              fail_at: Optional[int] = None, device="cuda",
              model: Optional[LanguageModel] = None,
              ckpt_dir: Optional[str] = None) -> E2ERun:
    """Train llama-100m for ``steps`` steps with a checkpoint every 50,
    a ``NodeFailure`` at ``fail_at`` and a restart from the latest
    checkpoint in ``ckpt_dir`` (default a new temporary directory).
    ``model`` (fp32 parameters on ``device``) gives the initial weights,
    else ``init_params(cfg, seed=0)``; the restart gets a fresh copy of
    them, never the model the failed call trained in place, so a failure
    before the first checkpoint starts again from the initial weights."""
    device = resolve_device(device)
    register_100m()
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="rowclone_e2e_")
    print(f"[e2e] checkpoints -> {ckpt_dir}")
    fresh = copy.deepcopy(model) if model is not None else None
    kw = dict(steps=steps, batch=batch, seq_len=seq_len, smoke=False,
              ckpt_dir=ckpt_dir, checkpoint_every=50, log_every=10,
              learning_rate=1e-3, device=device)

    def run(**extra):
        out = train_loop("llama-100m", **kw, **extra)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    reg = obs_metrics.registry()
    held = {n: len(reg.hist(n)) for n in CKPT_SERIES}
    failure = None
    with obs_metrics.Stopwatch() as sw:
        try:
            state, losses = run(inject_failure_at=fail_at, model=model)
        except NodeFailure as e:
            failure = e
    failed_s, finished_s = 0.0, sw.s
    if failure is not None:
        print(f"[e2e] {failure} — restarting from checkpoint "
              f"(fault-tolerance path)")
        with obs_metrics.Stopwatch() as sw:
            state, losses = run(model=fresh)
        failed_s, finished_s = finished_s, sw.s
    print(f"[e2e] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps (resumed runs replay identical data)")
    ckpt_ms = {n.split(".")[1][:-3]: [us / 1e3 for us in reg.hist(n)[held[n]:]]
               for n in CKPT_SERIES}
    print(f"[e2e] timing on {device}: {len(losses)} steps in "
          f"{finished_s:.2f}s ({1e3 * finished_s / len(losses):.1f} ms a "
          f"step, set-up and checkpoints included); checkpoint "
          + ", ".join(f"{k} ms {[round(x, 1) for x in v]}"
                      for k, v in ckpt_ms.items()))
    return E2ERun(state, losses, failure is not None, failed_s, finished_s,
                  ckpt_ms)


def main(argv=None) -> E2ERun:
    """CLI: train on ``--device`` (default the card; without a GPU pass
    ``--device cpu``), failing at ``--fail-at`` (by default half way
    when ``--steps`` is at least 100)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step to demo restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    fail_at = args.fail_at
    if fail_at is None and args.steps >= 100:
        fail_at = args.steps // 2  # demo the restart path by default
    return train_e2e(args.steps, args.batch, args.seq_len, fail_at,
                     args.device)


if __name__ == "__main__":
    main()
