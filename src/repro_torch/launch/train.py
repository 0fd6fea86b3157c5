"""Training of the port (port of ``repro/launch/train.py``): the
train step with mixed precision and microbatch accumulation, and the loop
with checkpoints, restarts and the straggler ledger.

Mixed precision is the reference's ``cast_bf16``: the fp32 master weights
are held as the model's parameters, and each step computes the loss
against bf16 views of every fp32 parameter with ``ndim > 1`` (``conv_w``
and the moe router included; 1-D leaves stay fp32).  The views are made
through autograd, so the grads land on the fp32 masters; the model runs
with them in place of its parameters (``torch.func.functional_call``)
through its forward AND its backward, because backward recomputes the
checkpointed blocks from the module's attributes.  At the reduced
configs (fp32 activations) the bf16-rounded weights then meet fp32
activations, as in the reference.

The reference's ``build_jit_train_step`` shards and jits the step over a
mesh; it has no counterpart until the mesh (ROADMAP item 12b), nor have
``mesh=`` and the compressed DP all-reduce (``optim/compress.py``).

CLI (CPU-sized by default, ``--full`` for the published width):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 8 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import make_batch, to_device
from repro_torch.models.lm import LanguageModel
from repro_torch.optim import AdamWState, apply_updates, init_state
from repro_torch.runtime import HeartbeatLedger, NodeFailure
from repro_torch.weights import init_params, resolve_device


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # the model's fp32 master parameters
    opt: AdamWState


def train_state(model: LanguageModel) -> TrainState:
    """The state that trains ``model``: its own parameters (made to
    require grad) and a fresh optimizer state."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params, init_state(params))


def bf16_views(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's ``cast_bf16``: every fp32 parameter with ``ndim >
    1`` as a bf16 tensor made through autograd, the others as they are."""
    return {n: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and p.ndim > 1 else p
            for n, p in params.items()}


class _LossAndGrads(nn.Module):
    """The loss and its grads in one call, so that ``functional_call``'s
    substitution lasts through backward's recomputations."""

    def __init__(self, model: LanguageModel):
        super().__init__()
        self.model = model

    def forward(self, batch, remat: str, wrt: List[torch.Tensor]):
        total, metrics = self.model.loss_fn(batch, remat)
        grads = torch.autograd.grad(total, wrt)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads


def make_train_step(model: LanguageModel, tcfg: TrainConfig, mesh=None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``, the state
    updated IN PLACE (``optim/adamw.py``).  ``batch``: tensors on the
    model's device (``data.to_device``).  ``tcfg.microbatches = m > 1``
    splits the batch's leading dim into m slices, sums their fp32 grads
    and divides the grads and the loss by m.  Metrics: ``loss`` (the
    cross-entropy; with m > 1 the mean total), ``aux`` (m = 1), ``grad_norm``
    and ``lr``, as 0-d tensors."""
    if mesh is not None:
        raise NotImplementedError("sharded training needs the mesh "
                                  "(ROADMAP item 12b)")
    run = _LossAndGrads(model)

    def grads_of(params, batch):
        views = bf16_views(params)
        return torch.func.functional_call(
            run, {f"model.{n}": v for n, v in views.items()},
            (batch, tcfg.remat_policy, list(params.values())))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        m = tcfg.microbatches
        if m > 1:
            mbs = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                   for k, v in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in params.values()]
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for i in range(m):
                total, _, grads = grads_of(params,
                                           {k: v[i] for k, v in mbs.items()})
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                loss = loss + total
            grads = [a.div_(m) for a in acc]
            loss = loss / m
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        grads = dict(zip(params, grads))
        _, opt, om = apply_updates(params, grads, state.opt, tcfg)
        return TrainState(params, opt), {"loss": loss, **metrics, **om}

    return train_step


def _load(state: TrainState, saved: TrainState) -> None:
    """Copy a restored state into the live one (the model's parameters
    and the moments are the tensors the step updates in place)."""
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(saved.params[n])
        state.opt.step.copy_(saved.opt.step)
        for live, kept in ((state.opt.m, saved.opt.m),
                           (state.opt.v, saved.opt.v)):
            for n, t in live.items():
                t.copy_(kept[n])


def train_loop(arch: str, steps: int = 50, batch: int = 4, seq_len: int = 128,
               smoke: bool = True, ckpt_dir: Optional[str] = None,
               microbatches: int = 1, mesh=None,
               inject_failure_at: Optional[int] = None, log_every: int = 10,
               checkpoint_every: int = 20, seed: int = 0,
               learning_rate: float = 3e-4, *, device="cuda",
               model: Optional[LanguageModel] = None,
               async_save: bool = True) -> Tuple[TrainState, List[float]]:
    """Synthetic ``data.make_batch`` batches through the train step, with
    checkpoints every ``checkpoint_every`` steps into ``ckpt_dir`` (and a
    restore from its latest checkpoint on entry) and a ``NodeFailure``
    raised at step ``inject_failure_at``.  The weights are fp32 masters
    from ``init_params(cfg, seed)`` unless ``model`` (fp32 parameters, on
    ``device``) is given; ``async_save=False`` writes each checkpoint
    before the next step.  Returns (the state, the losses of the steps
    run)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    tcfg = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                       microbatches=microbatches, seed=seed,
                       learning_rate=learning_rate)
    if model is None:
        model = init_params(cfg, seed=tcfg.seed, device=device,
                            param_dtype=torch.float32)
    state = train_state(model)
    step_fn = make_train_step(model, tcfg, mesh)

    ckpt = CheckpointManager(ckpt_dir, async_save=async_save) \
        if ckpt_dir else None
    ledger = HeartbeatLedger()
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        saved, start = ckpt.restore(state)
        _load(state, saved)
        print(f"[train] restored step {start}")

    losses = []
    for step in range(start, steps):
        if inject_failure_at is not None and step == inject_failure_at:
            raise NodeFailure(f"injected at step {step}")
        ledger.step_start()
        state, metrics = step_fn(
            state, to_device(make_batch(cfg, batch, seq_len, step), device))
        losses.append(float(metrics["loss"]))
        rep = ledger.step_end(step)
        if rep is not None:
            print(f"[straggler] step {rep.step} {rep.ratio:.1f}x median")
        if step % log_every == 0:
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.wait()
    return state, losses


def main() -> None:
    """CLI wrapper over :func:`train_loop`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, losses = train_loop(args.arch, steps=args.steps, batch=args.batch,
                           seq_len=args.seq_len, smoke=args.smoke,
                           ckpt_dir=args.ckpt_dir,
                           microbatches=args.microbatches,
                           device=args.device)
    print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
