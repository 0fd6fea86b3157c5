"""Mixture-of-experts FFN (port of ``repro/models/moe.py``): top-k
routing with capacity-buffer dispatch, on one device and over a rank mesh.

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

:func:`moe_ffn` picks the reference's path from the mesh
(:func:`moe_path`): no mesh (or one rank), :func:`moe_ffn_local`; under
rules that shard ``act_seq_tp`` and a mesh with a ``model`` axis,
:func:`moe_ffn_a2a`, where each rank routes its own token shard with a
capacity from its own token count and the experts are split over
``model``; otherwise :func:`moe_ffn_fsdp`, where each rank routes its
batch rows through the local path.  Each rank's work runs on its rank's
device, so ranks that share a device exchange tensors by reindexing and
ranks on other cards by a copy.

The expert products are plain ``torch`` products: the reference computes
them as ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.common import swiglu_mlp
from repro_torch.models.paged import batch_shard_axes, batch_shard_count
from repro_torch.sharding.rules import active_rules

CAPACITY_FACTOR = 1.25

#: when set, :func:`route` hands each call's top-k expert indices (B, N, k)
#: to it and routes by the indices it returns (the gates are then read
#: from the call's own probabilities).  ``chip_smoke.py`` sets it to
#: record one run's choices and count or replay them in another; None
#: everywhere else.
ROUTE_HOOK: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

#: calls of :func:`moe_ffn` by the path they took (``"local"``,
#: ``"fsdp"``, ``"a2a"``; a path that fell back counts as ``"local"``),
#: forward calls only: a checkpointed layer's recomputation during
#: backward counts in :data:`RECOMPUTE_COUNTS`
PATH_COUNTS: Dict[str, int] = collections.Counter()
RECOMPUTE_COUNTS: Dict[str, int] = collections.Counter()


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
    router product is in the activation dtype on x's device (the router
    is copied there when it lies elsewhere), the softmax in fp32.
    Equal probabilities rank the lower expert first, as the reference's
    ``lax.top_k`` (``torch.topk`` leaves their order to the device)."""
    B, N, _ = x.shape
    E = router.shape[1]
    logits = (x @ router.to(x.device, x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[..., :k], idx_k[..., :k]
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


def expert_ffn(p: MoEFFN, rows: torch.Tensor,
               experts: slice = slice(None)) -> torch.Tensor:
    """The SwiGLU of each expert of ``experts`` (default all) on its rows
    of the capacity buffer, rows (E', n, d) -> (E', n, d), as three
    batched products over E', with the weights on the rows' device."""
    dt, dev = rows.dtype, rows.device
    g = torch.bmm(rows, p.w_gate[experts].to(dev, dt))
    u = torch.bmm(rows, p.w_up[experts].to(dev, dt))
    return torch.bmm(F.silu(g) * u, p.w_down[experts].to(dev, dt))


def moe_ffn_local(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-device path (the reference's ``_moe_ffn_local``): x
    (B, S, d) -> (y (B, S, d) in x's dtype, aux loss fp32 scalar), on x's
    device."""
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
    return _shared(p, x, y), _aux(idx_k, probs, logits, E)


def _aux(idx_k: torch.Tensor, probs: torch.Tensor, logits: torch.Tensor,
         E: int) -> torch.Tensor:
    """Switch load-balance loss + 1e-3 x router z-loss over the tokens of
    ``idx_k`` (..., k), ``probs`` / ``logits`` (..., E), fp32."""
    dims = tuple(range(idx_k.dim() - 1))
    frac = (F.one_hot(idx_k, E).sum(-2) > 0).float().mean(dim=dims)
    aux = E * (frac * probs.mean(dim=dims)).sum()
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    return aux + 1e-3 * zloss


def _shared(p: MoEFFN, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y plus the shared experts on x, with their weights on x's device."""
    if p.shared is None:
        return y
    return y + swiglu_mlp(x, *(w.to(x.device) for w in (
        p.shared.w_gate, p.shared.w_up, p.shared.w_down)))


# ---------------------------------------------------------------------------
# the mesh paths
# ---------------------------------------------------------------------------

def _rank(mesh: DeviceMesh, coord: Dict[str, int]) -> int:
    """The rank (row-major) at ``coord``; axes it does not name at 0."""
    r = 0
    for a, n in zip(mesh.axis_names, mesh.shape):
        r = r * n + coord.get(a, 0)
    return r


def _coords(mesh: DeviceMesh, axes: Sequence[str], i: int) -> Dict[str, int]:
    """The coordinates of joint index ``i`` over ``axes`` (row-major in
    the order given, as a ``PartitionSpec`` entry shards jointly)."""
    out = {}
    for a in reversed(tuple(axes)):
        n = mesh.axis_size(a)
        out[a], i = i % n, i // n
    return out


def fsdp_batch_axes(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """The axes :func:`moe_ffn_fsdp` shards the batch over: every pool
    axis of the mesh, else those but ``model``, else ``data``, the first
    whose joint size divides ``batch``; () when none does (the reference's
    ``_moe_ffn_fsdp`` then runs the local path)."""
    all_axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.axis_names)
    for cand in (all_axes, tuple(a for a in all_axes if a != "model"),
                 ("data",)):
        present = tuple(a for a in cand if a in mesh.axis_names)
        if present and batch % math.prod(mesh.axis_size(a)
                                         for a in present) == 0:
            return present
    return ()


def a2a_layout(mesh: DeviceMesh, shape: Sequence[int], cfg: ModelConfig
               ) -> Optional[Tuple[Tuple[str, ...], int, int]]:
    """(the batch axes, their joint size dp, the ``model`` size T) of
    :func:`moe_ffn_a2a` for x of ``shape`` (B, S, d), or None where the
    reference falls back to the local path: S % T, B % dp (with batch
    axes) or E % T nonzero."""
    B, S = shape[0], shape[1]
    T = mesh.axis_size("model")
    axes = batch_shard_axes(mesh, B)
    replicated = not axes and any(a in mesh.axis_names
                                  for a in ("pod", "data"))
    if S % T or replicated or cfg.num_experts % T:
        return None
    return axes, batch_shard_count(mesh, B), T


def moe_path(mesh: Optional[DeviceMesh], shape: Sequence[int],
             cfg: ModelConfig) -> str:
    """The path :func:`moe_ffn` takes for x of ``shape`` under ``mesh``
    and the active rules (the reference's ``moe_ffn``, ``moe.py:56-73``,
    with the fallbacks of its two mesh paths): ``"local"``, ``"fsdp"`` or
    ``"a2a"``."""
    if mesh is None or mesh.size == 1:
        return "local"
    tp_mode = active_rules().get("act_seq_tp", (None,))[0] is not None
    if tp_mode and "model" in mesh.axis_names:
        return "a2a" if a2a_layout(mesh, shape, cfg) else "local"
    return "fsdp" if fsdp_batch_axes(mesh, shape[0]) else "local"


def moe_ffn(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[DeviceMesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype on x's device, aux loss
    fp32 scalar), by the path :func:`moe_path` names (counted in
    :data:`PATH_COUNTS`, or in :data:`RECOMPUTE_COUNTS` when backward
    recomputes it).  Every path carries gradients."""
    path = moe_path(mesh, x.shape, cfg)
    in_backward = torch._C._current_graph_task_id() != -1
    (RECOMPUTE_COUNTS if in_backward else PATH_COUNTS)[path] += 1
    if path == "a2a":
        return moe_ffn_a2a(p, x, cfg, mesh)
    if path == "fsdp":
        return moe_ffn_fsdp(p, x, cfg, mesh)
    return moe_ffn_local(p, x, cfg)


def moe_ffn_fsdp(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig,
                 mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_fsdp``: the batch shards over
    :func:`fsdp_batch_axes`; each shard's rank runs :func:`moe_ffn_local`
    on its rows on its device, and aux is the mean over the shards (the
    reference's ``pmean``; ranks that hold the same shard repeat its
    value).  The local path when no axis group divides the batch."""
    axes = fsdp_batch_axes(mesh, x.shape[0])
    if not axes:
        return moe_ffn_local(p, x, cfg)
    n = math.prod(mesh.axis_size(a) for a in axes)
    ys, auxs = [], []
    for i, rows in enumerate(x.chunk(n)):
        dev = mesh.devices[_rank(mesh, _coords(mesh, axes, i))]
        y, aux = moe_ffn_local(p, rows.to(dev), cfg)
        ys.append(y.to(x.device))
        auxs.append(aux.to(x.device))
    return torch.cat(ys), torch.stack(auxs).mean()


def route_local(xf: torch.Tensor, router: torch.Tensor, k: int, C: int):
    """The reference's ``_route_local``: route N tokens xf (N, d) as one
    row with capacity ``C``; :func:`route`'s outputs without the batch
    axis."""
    return tuple(t[0] for t in route(xf[None], router, k, C))


def moe_ffn_a2a(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig,
                mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_a2a`` as a per-rank dataflow.

    Rank (g, t) of the (pod, data) group g and ``model`` index t holds
    the token shard x[g-th B/dp rows, t-th S/T positions], routes its
    N_loc = (B/dp)(S/T) tokens with capacity C from N_loc (not from S),
    and packs an (E, C, d) send buffer.  The all-to-all hands rank u of
    the group slice u, (E/T, C, d), of every rank's buffer; rank u runs
    its E/T experts (its slice of the weights) over its (E/T, T·C, d)
    tokens; the inverse exchange returns each rank its (E, C, d) outputs,
    which it combines with its gates.  A slice that stays on its device is
    a view, one that changes device a copy.  aux is the sum of the shards'
    over ``n_dev = T·dp``.  The shared experts then run on the whole x.
    The local path where :func:`a2a_layout` says the reference falls
    back."""
    layout = a2a_layout(mesh, x.shape, cfg)
    if layout is None:
        return moe_ffn_local(p, x, cfg)
    dp_axes, dps, T = layout
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    E_l, B_l, S_l = E // T, B // dps, S // T
    N = B_l * S_l
    C = capacity(cfg, N)
    y = torch.empty_like(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(dps):
        coord = _coords(mesh, dp_axes, g)
        devs = [mesh.devices[_rank(mesh, dict(coord, model=t))]
                for t in range(T)]
        rows = slice(g * B_l, (g + 1) * B_l)
        routes, sends = [], []
        for t, dev in enumerate(devs):
            xf = x[rows, t * S_l:(t + 1) * S_l].reshape(N, d).to(dev)
            gate_k, idx_k, pos_k, keep_k, probs, logits = route_local(
                xf, p.router, k, C)
            xk = torch.where(keep_k[..., None], xf[:, None, :],
                             torch.zeros((), dtype=x.dtype, device=dev))
            buf = torch.zeros((E, C, d), dtype=x.dtype, device=dev)
            buf.index_put_((idx_k.reshape(-1), pos_k.reshape(-1)),
                           xk.reshape(-1, d), accumulate=True)
            sends.append(buf.view(T, E_l, C, d))
            routes.append((gate_k, idx_k, pos_k, keep_k))
            aux = aux + _aux(idx_k, probs, logits, E).to(x.device)
        # exchange: rank u's tokens are slice u of every rank's buffer,
        # laid out (E_l, T, C, d) as the reference's swapaxes
        outs = []
        for u, dev in enumerate(devs):
            tokens = torch.stack([s[u].to(dev) for s in sends], 1)
            outs.append(expert_ffn(p, tokens.view(E_l, T * C, d),
                                   slice(u * E_l, (u + 1) * E_l))
                        .view(E_l, T, C, d))
        # the inverse exchange and each rank's combine
        for t, dev in enumerate(devs):
            mine = torch.cat([o[:, t].to(dev) for o in outs])
            gate_k, idx_k, pos_k, keep_k = routes[t]
            picked = mine[idx_k, pos_k]                          # (N, k, d)
            w = (gate_k * keep_k).to(x.dtype)
            yl = (w[:, None, :] @ picked)[:, 0, :]
            y[rows, t * S_l:(t + 1) * S_l] = yl.view(B_l, S_l, d).to(
                x.device)
    return _shared(p, x, y), aux / (T * dps)


__all__ = ["CAPACITY_FACTOR", "PATH_COUNTS", "RECOMPUTE_COUNTS", "ROUTE_HOOK",
           "MoEFFN", "SwiGLU", "a2a_layout", "capacity", "expert_ffn", "fsdp_batch_axes",
           "moe_ffn", "moe_ffn_a2a", "moe_ffn_fsdp", "moe_ffn_local",
           "moe_path", "route", "route_local"]
