"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (port of ``repro/optim/adamw.py``), over a flat dict of
parameters keyed by the port's names (``model.named_parameters()``).  A
parameter is a tensor or, over a rank mesh, a ``launch.mesh.Sharded``
whose blocks lie on their ranks' devices: each block, its grads and its
moments are updated where they lie, the decay decided by the
parameter's name.

The arithmetic is the reference's, in fp32 and in its order: ``m``, ``v``,
the bias corrections with the step as fp32, ``delta``, the decay on the
fp32 parameter, the cast back to the parameter's dtype.  Unlike the
reference, which returns new trees, :func:`clip_by_global_norm` and
:func:`apply_updates` work IN PLACE on the grads, the moments and the
parameters: a second copy of a 3.2B-parameter model's fp32 state does not
fit beside the first on one 80 GB card.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import TrainConfig
from repro_torch.launch.mesh import pieces, with_pieces
from repro_torch.weights import jax_path


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32, on the first parameter's
    m: Dict[str, torch.Tensor]         # like params, fp32
    v: Dict[str, torch.Tensor]         # like params, fp32


def _zeros(p):
    return with_pieces(p, [torch.zeros_like(t, dtype=torch.float32)
                           for t in pieces(p)])


def init_state(params: Dict) -> AdamWState:
    """Step 0 (on the device of the first parameter's first piece) and
    zero moments laid out as the parameters."""
    dev = pieces(next(iter(params.values())))[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      {n: _zeros(p) for n, p in params.items()},
                      {n: _zeros(p) for n, p in params.items()})


def cosine_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then a cosine from the peak
    down to 10% of it at ``total_steps``; ``step`` a number or an fp32
    tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Dict) -> torch.Tensor:
    """The norm of every piece of every leaf, summed on the first piece's
    device."""
    ts = [t for x in tree.values() for t in pieces(x)]
    dev = ts[0].device
    return torch.sqrt(sum(t.float().square().sum().to(dev) for t in ts))


def clip_by_global_norm(grads: Dict, max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    """Scale the grads IN PLACE so that their global norm is at most
    ``max_norm``.  Returns (the grads, their norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        for t in pieces(g):
            t.mul_(scale.to(t.device))
    return grads, norm


#: substrings of the reference's tree path that exempt a parameter from
#: weight decay.  They match substrings: ``ln1``, ``ln2``, ``ln_x``,
#: ``bq`` / ``bk`` / ``bv`` and ``conv_b`` ARE decayed; ``final_norm``,
#: ``enc_norm``, ``norm``, ``gate_norm``, ``dt_bias``, ``A_log`` and ``D``
#: are not
_NO_DECAY_SUBSTR = ("norm", "bias", "A_log", "dt_bias", "D")


def decays(name: str) -> bool:
    """Whether the parameter ``name`` is decayed: the reference's
    ``_decay_mask`` on its JAX path (``weights.jax_path``)."""
    path = "/".join(jax_path(name)[0])
    return not any(s in path for s in _NO_DECAY_SUBSTR)


@torch.no_grad()
def apply_updates(params: Dict, grads: Dict, state: AdamWState,
                  cfg: TrainConfig
                  ) -> Tuple[Dict, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: clip the grads, update ``m`` / ``v`` and the
    parameters IN PLACE, piece by piece where each piece lies.  Returns
    (params, the state with the step advanced, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    stepf = step.float()
    lr = cosine_schedule(cfg, stepf)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    scalars = {}            # (lr, bc1, bc2) on each device a piece uses
    for n, par in params.items():
        for p, g, m, v in zip(pieces(par), pieces(grads[n]),
                              pieces(state.m[n]), pieces(state.v[n])):
            if p.device not in scalars:
                scalars[p.device] = [t.to(p.device) for t in (lr, bc1, bc2)]
            lr_d, bc1_d, bc2_d = scalars[p.device]
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square() * (1 - b2))
            mh = m / bc1_d
            delta = mh.div_((v / bc2_d).sqrt_().add_(1e-8))
            p32 = p.float()
            if decays(n):
                delta.add_(cfg.weight_decay * p32)
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr_d))
            else:
                p.copy_(p32 - lr_d * delta)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWState", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "decays", "global_norm", "init_state"]
