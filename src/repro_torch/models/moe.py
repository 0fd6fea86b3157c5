"""Mixture-of-experts FFN (port of ``repro/models/moe.py``, its
single-device path): top-k routing with capacity-buffer dispatch.

Each batch row routes its own tokens: a choice's position in its expert is
a running count over the k choices taken in order, and a choice at or past
the capacity ``C`` is dropped (it adds zero into slot ``C - 1`` and is
gathered back with weight 0, as in the reference).  The kept tokens are
scattered into a capacity buffer (the reference's ``(B, E, C, d)``, held
expert-major as ``(E, B, C, d)`` so that the products need no transpose),
every expert runs its SwiGLU on its rows as one batched product over E,
and the outputs are gathered back with the renormalised top-k gates.
DeepSeek-style shared experts are a dense SwiGLU of hidden size
``num_shared_experts * moe_d_ff`` applied to every token.  A load-balance
aux loss and the router z-loss are returned beside the output; serving
discards them.

The expert products are plain ``torch`` products: the reference computes
them as ``jnp.einsum`` outside any Pallas kernel.  The mesh paths
(``_moe_ffn_fsdp``, ``_moe_ffn_a2a``) are not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.common import swiglu_mlp

CAPACITY_FACTOR = 1.25

#: when set, :func:`route` hands each call's top-k expert indices (B, N, k)
#: to it and routes by the indices it returns (the gates are then read
#: from the call's own probabilities).  ``chip_smoke.py`` sets it to
#: record one run's choices and count or replay them in another; None
#: everywhere else.
ROUTE_HOOK: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert for ``seq_len`` tokens of one batch row: the fair
    share times :data:`CAPACITY_FACTOR`, rounded up to a multiple of 8,
    at least 8."""
    c = int(math.ceil(seq_len * cfg.top_k / cfg.num_experts *
                      CAPACITY_FACTOR))
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor, k: int, C: int):
    """Route the tokens of each batch row: x (B, N, d), router (d, E).

    Returns (gate_k, idx_k, pos_k, keep_k, probs, logits): renormalised
    gates (B, N, k) fp32, expert indices and positions in the expert
    (B, N, k) int64 with ``pos_k`` clipped to ``C - 1``, ``keep_k`` =
    position < C, and the fp32 probabilities and logits (B, N, E).  The
    router product is in the activation dtype, the softmax in fp32."""
    B, N, _ = x.shape
    E = router.shape[1]
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.topk(probs, k, dim=-1)
    if ROUTE_HOOK is not None:
        idx_k = ROUTE_HOOK(idx_k)
        gate_k = probs.gather(-1, idx_k)
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    # position-in-expert: a running count over choice 0 of every token,
    # then choice 1 of every token, ... (the reference's sequential cumsum),
    # expert-major so that the count runs along the innermost dimension
    flat = idx_k.transpose(1, 2).reshape(B, 1, k * N)
    onehot = (flat == torch.arange(E, device=x.device)[:, None]).long()
    pos = ((onehot.cumsum(-1) - onehot) * onehot).sum(1)
    pos_k = pos.reshape(B, k, N).transpose(1, 2)
    keep_k = pos_k < C
    return gate_k, idx_k, pos_k.clamp(max=C - 1), keep_k, probs, logits


class SwiGLU(nn.Module):
    """The weights of one dense SwiGLU (the shared experts)."""

    def __init__(self, d: int, f: int, dtype: torch.dtype, device):
        super().__init__()
        for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                            ("w_down", (f, d))):
            setattr(self, name, nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device),
                requires_grad=False))


class MoEFFN(nn.Module):
    """The weights of one moe FFN, in the reference's names and layouts:
    ``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, f), ``w_down``
    (E, f, d), and ``shared`` (a :class:`SwiGLU` of hidden size
    ``num_shared_experts * f``) when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        d, E = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        for name, shape in (("router", (d, E)), ("w_gate", (E, d, f)),
                            ("w_up", (E, d, f)), ("w_down", (E, f, d))):
            setattr(self, name, nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device),
                requires_grad=False))
        self.shared = (SwiGLU(d, cfg.num_shared_experts * f, dtype, device)
                       if cfg.num_shared_experts else None)


def expert_ffn(p: MoEFFN, rows: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its rows of the capacity buffer, rows
    (E, n, d) -> (E, n, d), as three batched products over E."""
    dt = rows.dtype
    g = torch.bmm(rows, p.w_gate.to(dt))
    u = torch.bmm(rows, p.w_up.to(dt))
    return torch.bmm(F.silu(g) * u, p.w_down.to(dt))


def moe_ffn_local(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss fp32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    dt = x.dtype
    gate_k, idx_k, pos_k, keep_k, probs, logits = route(x, p.router, k, C)

    # scatter the kept choices into the capacity buffer, expert-major
    eidx = idx_k.reshape(-1)
    bidx = torch.arange(B, device=x.device).repeat_interleave(S * k)
    cidx = pos_k.reshape(-1)
    xb = torch.where(keep_k[..., None], x[:, :, None, :],
                     torch.zeros((), dtype=dt, device=x.device))
    buf = torch.zeros((E, B, C, d), dtype=dt, device=x.device)
    buf.index_put_((eidx, bidx, cidx), xb.reshape(-1, d), accumulate=True)

    out = expert_ffn(p, buf.view(E, B * C, d)).view(E, B, C, d)

    # gather back, weighted by gate * keep
    picked = out[eidx, bidx, cidx].view(B, S, k, d)
    w = (gate_k * keep_k).to(dt)
    y = (w[:, :, None, :] @ picked)[:, :, 0, :]
    if p.shared is not None:
        y = y + swiglu_mlp(x, p.shared.w_gate, p.shared.w_up,
                           p.shared.w_down)

    # switch load-balance loss + router z-loss
    frac = (F.one_hot(idx_k, E).sum(-2) > 0).float().mean(dim=(0, 1))
    aux = E * (frac * probs.mean(dim=(0, 1))).sum()
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    return y, aux + 1e-3 * zloss


__all__ = ["CAPACITY_FACTOR", "ROUTE_HOOK", "MoEFFN", "SwiGLU", "capacity",
           "expert_ffn", "moe_ffn_local", "route"]
