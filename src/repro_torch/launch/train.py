"""Training of the port (port of ``repro/launch/train.py``): the
train step with mixed precision and microbatch accumulation, on one
device or over a rank mesh, and the loop with checkpoints, restarts and
the straggler ledger.

Mixed precision is the reference's ``cast_bf16``: the fp32 master weights
are held as the model's parameters, and each step computes the loss
against bf16 views of every fp32 parameter with ``ndim > 1`` (``conv_w``
and the moe router included; 1-D leaves stay fp32).  The views are made
through autograd, so the grads land on the fp32 masters; the views are
set on the model's modules in place of its parameters for the call
(:func:`_views_set`), through its forward AND its backward, because
backward recomputes the checkpointed blocks from the module's
attributes.  At the reduced
configs (fp32 activations) the bf16-rounded weights then meet fp32
activations, as in the reference.

Over a rank mesh (``DeviceMesh``) the step computes the loss, its grads
and backward's recomputations under ``FSDP_RULES`` when
``tcfg.sharding == "fsdp"``, else ``DEFAULT_RULES`` (the reference's
``use_rules``).  :func:`build_train_step` is the counterpart of the
reference's ``build_jit_train_step``: its ``shard_state`` gives each
parameter's ``launch.mesh.Sharding`` from its logical axes
(``weights.params_axes``), and ``train_state(model, shardings)`` places
the fp32 masters and both moments as the blocks each rank's coordinates
select, each once, on its rank's device, releasing the model's own
tensors.  A step casts each block to bf16 where it lies (the views stay
placed: nothing is gathered whole), sets the views on the model's modules
for the call, lays the batch out by the reference's batch shardings, and
the model computes every block of the loss, and of its backward and
backward's recomputations, on the rank that holds it
(``LanguageModel.loss_fn(mesh=)``): a weight's ZeRO-3 dimension gathered
on each rank for its use, the partial products summed into their blocks,
the loss's sums added on the mesh's first rank.  Autograd brings each
block its grads where it lies, and AdamW updates each block there.

CLI (CPU-sized by default, ``--full`` for the published width):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 8 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_logical_axes, make_batch, to_device
from repro_torch.launch.mesh import (DeviceMesh, Sharded, gather, map_blocks,
                                     pieces, place, sharding_for, take,
                                     tree_shardings, with_pieces)
from repro_torch.models.lm import LanguageModel
from repro_torch.optim import AdamWState, apply_updates, init_state
from repro_torch.runtime import HeartbeatLedger, NodeFailure
from repro_torch.sharding.rules import DEFAULT_RULES, FSDP_RULES, use_rules
from repro_torch.weights import init_params, params_axes, resolve_device


class TrainState(NamedTuple):
    #: the fp32 masters: the model's own parameters, or over a mesh
    #: ``launch.mesh.Sharded`` blocks (a leaf the spec does not shard:
    #: one tensor on the first rank's device)
    params: Dict[str, object]
    opt: AdamWState


def train_rules(tcfg: TrainConfig) -> Dict:
    """The rule set a step runs under: ``FSDP_RULES`` for
    ``sharding="fsdp"``, else ``DEFAULT_RULES``."""
    return FSDP_RULES if tcfg.sharding == "fsdp" else DEFAULT_RULES


def train_state(model: LanguageModel,
                shardings: Optional[TrainState] = None) -> TrainState:
    """The state that trains ``model``: its own parameters (made to
    require grad) and a fresh optimizer state.  With ``shardings`` (the
    ``shard_state`` of :func:`build_train_step`), each parameter is
    placed by its ``Sharding`` and the model's own tensor released (the
    masters are held once; the model then runs only through a step), and
    the moments are zeros in the same layout."""
    params = dict(model.named_parameters())
    if shardings is not None:
        placed = {}
        for n, p in params.items():
            placed[n] = place(p, shardings.params[n])
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        params = placed
    for p in params.values():
        for t in pieces(p):
            t.requires_grad_(True)
    return TrainState(params, init_state(params))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """The reference's ``cast_bf16`` of one tensor: bf16 for an fp32
    tensor of ``ndim > 1``, else itself."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 and t.ndim > 1 \
        else t


def bf16_views(params: Dict, device=None) -> Dict[str, object]:
    """The reference's ``cast_bf16``: every fp32 parameter with ``ndim >
    1`` as a bf16 value made through autograd, the others as they are.  A
    ``Sharded`` master stays a ``Sharded`` of the same blocks read as bf16
    (``Sharded.cast``): each reader's ``take`` casts its part of a block
    where the block lies and moves the bf16 bytes, nothing is gathered,
    and the readers' bf16 grads are summed in fp32 on the master block
    (the sum of per-rank partial products that one device's fp32
    accumulation would make, rounded once a rank); a tensor is cast on its
    device (moved to ``device`` when one is given)."""
    out = {}
    for n, p in params.items():
        if isinstance(p, Sharded):
            out[n] = Sharded(p.sharding, p.shape, p.blocks, torch.bfloat16) \
                if p.dtype == torch.float32 and p.ndim > 1 else p
        else:
            v = _bf16(p)
            out[n] = v if device is None else v.to(device)
    return out


@contextlib.contextmanager
def _views_set(model: LanguageModel, views: Dict[str, object]):
    """``model``'s modules hold ``views`` (bf16 values, placed or not,
    which are not parameters) in place of their parameters for the call,
    forward and backward's recomputations, as ``weights.place_params``
    sets its blocks; the parameters come back on exit."""
    popped = []
    try:
        for name, v in views.items():
            owner, attr = model, name
            if "." in name:
                path, attr = name.rsplit(".", 1)
                owner = model.get_submodule(path)
            popped.append((owner, attr, owner._parameters.pop(attr)))
            setattr(owner, attr, v)
        yield
    finally:
        for owner, attr, p in popped:
            owner.__dict__.pop(attr, None)
            owner._parameters[attr] = p


def place_batch(batch: Dict, mesh: DeviceMesh, tcfg: TrainConfig,
                axes: Dict[str, tuple], rows: Optional[slice] = None
                ) -> Dict[str, object]:
    """Each leaf of ``batch`` laid out by the reference's
    ``batch_shardings`` (``axes``: ``data.batch_logical_axes``, under
    :func:`train_rules`): a leaf placed so already is used as it lies, any
    other (whole on any device, or placed otherwise) has each block taken
    onto its owner.  ``rows``: only those leading rows (a microbatch: the
    reference's reshape ``(m, B / m, ...)`` takes microbatch i's rows
    ``[i B / m, (i + 1) B / m)``), laid out by the spec of their shape."""
    out = {}
    with use_rules(train_rules(tcfg)):
        for k, v in batch.items():
            lo = 0 if rows is None else rows.start
            shape = tuple(v.shape) if rows is None else \
                (rows.stop - rows.start,) + tuple(v.shape[1:])
            sh = sharding_for(mesh, shape, axes[k])
            if rows is None and isinstance(v, Sharded) and v.sharding == sh:
                out[k] = v
            elif rows is None and not isinstance(v, Sharded):
                out[k] = place(v, sh)
            else:
                out[k] = map_blocks(sh, shape, lambda b, sl, r, _v=v: take(
                    _v, r, (slice(lo + sl[0].start, lo + sl[0].stop),)
                    + sl[1:], mesh=mesh, path="place"))
    return out


def loss_and_grads(model: LanguageModel, params: Dict, batch: Dict,
                   tcfg: TrainConfig, mesh: Optional[DeviceMesh] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """The loss of ``batch`` against bf16 views of ``params`` and its
    grads, laid out as ``params`` (a sharded parameter's grads as its
    blocks).  Over ``mesh`` of more than one rank the views stay placed
    (:func:`bf16_views`), the batch is laid out by :func:`place_batch`,
    and the model computes every block of the loss, and of its backward,
    on the rank that holds it (``LanguageModel.loss_fn(mesh=)``, with the
    views set on its modules), under :func:`train_rules`, backward's
    recomputations included; the loss lies on the mesh's first rank.
    Returns (total, {"loss", "aux"}, grads).  Each piece of ``params`` is
    made to require grad (a restored state's too)."""
    wrt = [t.requires_grad_(True) for p in params.values()
           for t in pieces(p)]
    placed = mesh is not None and mesh.size > 1
    if placed:
        views = bf16_views(params)
        batch = place_batch(batch, mesh, tcfg,
                            batch_logical_axes(model.cfg))
    else:
        device = mesh.devices[0] if mesh is not None else None
        views = bf16_views(params, device)
        if device is not None:
            batch = {k: gather(v, device) for k, v in batch.items()}
    # ranks on two devices: backward on one thread, since torch's
    # non-reentrant checkpoint starts a frame's recomputation without a
    # lock, and two autograd device threads would both start it
    one_thread = placed and len(set(mesh.devices)) > 1
    with use_rules(train_rules(tcfg)), _views_set(model, views), \
            torch.autograd.set_multithreading_enabled(not one_thread):
        total, metrics = model.loss_fn(batch, tcfg.remat_policy,
                                       mesh if placed else None)
        flat = torch.autograd.grad(total, wrt)
    total = total.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads, i = {}, 0
    for n, p in params.items():
        k = len(pieces(p))
        grads[n] = with_pieces(p, flat[i:i + k])
        i += k
    return total, metrics, grads


def make_train_step(model: LanguageModel, tcfg: TrainConfig,
                    mesh: Optional[DeviceMesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``, the state
    updated IN PLACE (``optim/adamw.py``).  ``batch``: tensors on the
    model's device (``data.to_device``); over ``mesh`` on any device, or
    placed, and laid out by the reference's batch shardings
    (:func:`place_batch`: a placed batch is used as it lies, nothing is
    gathered).  ``tcfg.microbatches = m > 1`` splits the batch's leading
    dim into m slices (over a mesh each laid out again by the batch spec),
    sums their fp32 grads and divides the grads and the loss by m.
    Metrics: ``loss`` (the cross-entropy; with m > 1 the mean total),
    ``aux`` (m = 1), ``grad_norm`` and ``lr``, as 0-d tensors."""
    placed = mesh is not None and mesh.size > 1
    axes = batch_logical_axes(model.cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        m = tcfg.microbatches
        if m > 1:
            B = next(iter(batch.values())).shape[0]
            if placed:
                mbs = [place_batch(batch, mesh, tcfg, axes,
                                   slice(i * B // m, (i + 1) * B // m))
                       for i in range(m)]
            else:
                mbs = [{k: v.reshape((m, B // m) + v.shape[1:])[i]
                        for k, v in batch.items()} for i in range(m)]
            acc = {n: with_pieces(p, [torch.zeros_like(
                t, dtype=torch.float32) for t in pieces(p)])
                for n, p in params.items()}
            loss = 0.0
            for mb in mbs:
                total, _, grads = loss_and_grads(model, params, mb, tcfg,
                                                 mesh)
                for n, g in grads.items():
                    for a, t in zip(pieces(acc[n]), pieces(g)):
                        a.add_(t.float())
                # one microbatch's grads live at a time, beside the sums
                del grads
                loss = loss + total
            grads = {n: with_pieces(a, [t.div_(m) for t in pieces(a)])
                     for n, a in acc.items()}
            loss = loss / m
            metrics = {}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  tcfg, mesh)
        _, opt, om = apply_updates(params, grads, state.opt, tcfg)
        return TrainState(params, opt), {"loss": loss, **metrics, **om}

    return train_step


def build_train_step(model: LanguageModel, tcfg: TrainConfig,
                     mesh: DeviceMesh, params_axes: Dict[str, tuple],
                     batch_ax: Dict[str, tuple]):
    """The counterpart of the reference's ``build_jit_train_step``
    (``repro/launch/train.py:103-124``): returns ``(step_fn, shard_state,
    batch_shardings)``.  ``shard_state(params_like)`` gives the
    ``TrainState`` of ``launch.mesh.Sharding`` (under
    :func:`train_rules`, from ``params_axes``, as
    ``weights.params_axes`` gives them): each parameter's and, laid out
    alike, each moment's; the optimizer step replicated.
    ``batch_shardings(batch_like)`` gives each batch leaf's from
    ``batch_ax`` (``data.batch_logical_axes``)."""
    rules = train_rules(tcfg)
    step_fn = make_train_step(model, tcfg, mesh)

    def shard_state(params_like) -> TrainState:
        with use_rules(rules):
            p_sh = tree_shardings(mesh, params_like, params_axes)
            return TrainState(p_sh, AdamWState(sharding_for(mesh, (), ()),
                                               p_sh, p_sh))

    def batch_shardings(batch_like) -> Dict:
        with use_rules(rules):
            return {k: sharding_for(mesh, v.shape, batch_ax[k])
                    for k, v in batch_like.items()}

    return step_fn, shard_state, batch_shardings


def _load(state: TrainState, saved: TrainState) -> None:
    """Copy a restored state into the live one (the parameters and the
    moments are the tensors the step updates in place), piece by
    piece."""
    with torch.no_grad():
        state.opt.step.copy_(saved.opt.step)
        for live, kept in ((state.params, saved.params),
                           (state.opt.m, saved.opt.m),
                           (state.opt.v, saved.opt.v)):
            for n, x in live.items():
                for a, b in zip(pieces(x), pieces(kept[n])):
                    a.copy_(b)


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
    raised at step ``inject_failure_at`` (once the checkpoint written
    before it has landed: the reference's loop does not wait for it, and
    its restart may miss a checkpoint saved just before the failure).
    The weights are fp32 masters from ``init_params(cfg, seed)`` unless
    ``model`` (fp32 parameters, on ``device``) is given;
    ``async_save=False`` writes each checkpoint before the next step.
    Over ``mesh`` the model is made on the mesh's first rank's device, the
    state is placed by :func:`build_train_step`'s shardings
    (``TrainConfig.sharding``'s default rules, as the reference's loop),
    the batches are made there, and a restore places the checkpoint for
    this mesh, whatever mesh saved it.  Returns (the state, the losses of
    the steps run)."""
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    tcfg = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                       microbatches=microbatches, seed=seed,
                       learning_rate=learning_rate)
    if model is None:
        model = init_params(cfg, seed=tcfg.seed, device=device,
                            param_dtype=torch.float32)
    shardings = None
    if mesh is None:
        step_fn = make_train_step(model, tcfg)
    else:
        step_fn, shard_state, _ = build_train_step(
            model, tcfg, mesh, params_axes(model), batch_logical_axes(cfg))
        shardings = shard_state(dict(model.named_parameters()))
    state = train_state(model, shardings)

    ckpt = CheckpointManager(ckpt_dir, async_save=async_save) \
        if ckpt_dir else None
    ledger = HeartbeatLedger()
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        saved, start = ckpt.restore(state, shardings=shardings)
        _load(state, saved)
        print(f"[train] restored step {start}")

    losses = []
    try:
        for step in range(start, steps):
            if inject_failure_at is not None and step == inject_failure_at:
                raise NodeFailure(f"injected at step {step}")
            ledger.step_start()
            state, metrics = step_fn(
                state,
                to_device(make_batch(cfg, batch, seq_len, step), device))
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
    finally:
        # a save issued before a failure lands before the failure
        # propagates, so that a restart finds it (a failure right after a
        # checkpoint would race its background write)
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
