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

A model whose weights ``weights.place_params`` placed, or a training
step's placed bf16 views, runs :func:`moe_ffn_placed` on a
:class:`~repro_torch.launch.mesh.Sharded` activation: the same path by
:func:`moe_path`, each rank computing with the experts it holds (the
reference's ``shard_map`` boundary and ``constrain`` points on the
weights ``tree_shardings`` placed), the shared experts column- /
row-parallel as a dense MLP, and in training the path's aux loss.

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
from repro_torch.launch.mesh import (DeviceMesh, Sharded, Sharding,
                                     map_blocks, rank_scope, relayout, take,
                                     to_rank, to_rank_of)
from repro_torch.models.common import (blockwise, spec_entry, swiglu_mlp,
                                       swiglu_mlp_placed)
from repro_torch.models.paged import batch_shard_axes, batch_shard_count
from repro_torch.sharding.rules import active_rules

CAPACITY_FACTOR = 1.25

#: when set, :func:`route` hands each call's top-k expert indices (B, N, k)
#: to it and routes by the indices it returns (the gates are then read
#: from the call's own probabilities).  A :class:`RouteLog` set here
#: records one run's choices and counts or replays them in another
#: (``chip_smoke.py``); None everywhere else.
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


class RouteLog:
    """A :data:`ROUTE_HOOK` over runs of one protocol.  In ``record`` mode
    it keeps each route call's top-k expert indices (B, N, k); in
    ``compare`` mode it counts, against the recorded calls in order, the
    choices a later run makes that the recorded run did not (flips);
    ``replay`` counts them too and routes the later run by the recorded
    indices.  Calls are matched by their tokens' rows: a later call may
    route a block of a recorded call's batch rows, and consecutive calls
    then take consecutive rows of it (a placed model's batch groups route
    their rows apart, in row order, where one device routes them in one
    call); :meth:`map_rows` says which recorded row each row of the later
    run's batch is (an engine over a mesh puts its sequences in other
    slots).  A call that matches no rows raises."""

    def __init__(self, num_experts: int):
        self.E = num_experts
        self.calls = []
        self.reset("record")

    def reset(self, mode: str) -> None:
        """Start a run in ``mode`` (``record``, ``compare``, ``replay``),
        its rows those of the recorded run."""
        self.mode, self.i, self.row, self.rows = mode, 0, 0, None
        self.flips, self.choices = [], 0

    def map_rows(self, rows: Optional[Sequence[int]]) -> None:
        """From the next call on, row j of this run's batch is the recorded
        run's row ``rows[j]`` (-1: a row the recorded run did not hold,
        neither counted nor replayed); None: row j is row j."""
        self.rows = None if rows is None else torch.as_tensor(rows)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        if self.mode == "record":
            self.calls.append(idx.clone())
            return idx
        b = idx.shape[0]
        full = self.calls[self.i] if self.i < len(self.calls) else None
        if full is None or idx.shape[1:] != full.shape[1:] or \
                self.row + b > full.shape[0]:
            raise ValueError(
                f"route call of {tuple(idx.shape)} matches no rows of the "
                f"recorded call {self.i}, from row {self.row} (of "
                f"{len(self.calls)} calls)")
        sel = torch.arange(self.row, self.row + b) if self.rows is None \
            else self.rows[self.row:self.row + b]
        self.row += b
        if self.row == full.shape[0]:
            self.i, self.row = self.i + 1, 0
        held = sel >= 0
        self.choices += int(held.sum()) * idx[0].numel()
        ref = torch.where(held.to(idx.device)[:, None, None],
                          full[sel.clamp(min=0)].to(idx.device), idx)
        mine = F.one_hot(idx, self.E).sum(-2)
        theirs = F.one_hot(ref, self.E).sum(-2)
        self.flips.append((mine > theirs).sum())
        return ref if self.mode == "replay" else idx

    def flipped(self) -> int:
        """Choices of this run that the recorded run did not make."""
        return int(torch.stack(self.flips).sum()) if self.flips else 0

    def consumed(self) -> bool:
        """Whether this run's calls covered every recorded row."""
        return self.i == len(self.calls) and self.row == 0


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
    y, routed = _routed(x, p.router, cfg, lambda rows: expert_ffn(p, rows))
    return _shared(p, x, y), _aux(*routed, cfg.num_experts)


def _routed(x: torch.Tensor, router, cfg: ModelConfig, experts):
    """The local path's routed experts on x (B, S, d), on x's device:
    route each batch row with capacity ``capacity(cfg, S)``, scatter the
    kept choices into the capacity buffer, expert-major, run
    ``experts(rows (E, B * C, d)) -> (E, B * C, d)`` on it, and gather
    back weighted by gate * keep.  Returns (y, (idx_k, probs, logits)),
    what :func:`_aux` reads."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    dt = x.dtype
    gate_k, idx_k, pos_k, keep_k, probs, logits = route(x, router, k, C)

    # scatter the kept choices into the capacity buffer, expert-major
    eidx = idx_k.reshape(-1)
    bidx = torch.arange(B, device=x.device).repeat_interleave(S * k)
    cidx = pos_k.reshape(-1)
    xb = torch.where(keep_k[..., None], x[:, :, None, :],
                     torch.zeros((), dtype=dt, device=x.device))
    buf = torch.zeros((E, B, C, d), dtype=dt, device=x.device)
    buf.index_put_((eidx, bidx, cidx), xb.reshape(-1, d), accumulate=True)

    out = experts(buf.view(E, B * C, d)).view(E, B, C, d)

    # gather back, weighted by gate * keep
    picked = out[eidx, bidx, cidx].view(B, S, k, d)
    w = (gate_k * keep_k).to(dt)
    return (w[:, :, None, :] @ picked)[:, :, 0, :], (idx_k, probs, logits)


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
        r = _rank(mesh, _coords(mesh, axes, i))
        with rank_scope(r):
            y, aux = moe_ffn_local(p, to_rank(rows, mesh, r, path="moe"),
                                   cfg)
        ys.append(to_rank_of(y, x, path="moe"))
        auxs.append(to_rank_of(aux, x, path="moe"))
    return torch.cat(ys), torch.stack(auxs).mean()


def route_local(xf: torch.Tensor, router: torch.Tensor, k: int, C: int):
    """The reference's ``_route_local``: route N tokens xf (N, d) as one
    row with capacity ``C``; :func:`route`'s outputs without the batch
    axis."""
    return tuple(t[0] for t in route(xf[None], router, k, C))


def moe_ffn_a2a(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig,
                mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_a2a`` as a per-rank dataflow
    (:func:`_a2a`) over x whole on its device: each rank's token shard is
    copied there from x, the router and each rank's E/T experts move to
    the rank's device with the work, and each rank's output is written
    back into y on x's device.  aux is the sum of the shards' over
    ``n_dev = T·dp``.  The shared experts then run on the whole x.  The
    local path where :func:`a2a_layout` says the reference falls back."""
    layout = a2a_layout(mesh, x.shape, cfg)
    if layout is None:
        return moe_ffn_local(p, x, cfg)
    _, dps, T = layout
    d = x.shape[2]
    E_l = cfg.num_experts // T
    y = torch.empty_like(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def put(rows, seqs, r, yl):
        y[rows, seqs] = to_rank_of(yl, x, path="all-to-all")

    for a in _a2a(cfg, mesh, layout, x.shape, x.dtype,
                  lambda r, rows, seqs: to_rank(x[rows, seqs].reshape(-1, d),
                                                mesh, r, path="all-to-all"),
                  lambda r: p.router,
                  lambda r, u, rows: expert_ffn(
                      p, rows, slice(u * E_l, (u + 1) * E_l)),
                  put, with_aux=True):
        aux = aux + to_rank_of(a, x, path="all-to-all")
    return _shared(p, x, y), aux / (T * dps)


def _a2a(cfg: ModelConfig, mesh: DeviceMesh, layout, shape, dtype,
         tokens_on, router_on, experts_on, put, with_aux: bool = False
         ) -> list:
    """The all-to-all's dataflow (the reference's ``_moe_ffn_a2a``).

    Rank (g, t) of the (pod, data) group g and ``model`` index t holds
    the token shard [g-th B/dp rows, t-th S/T positions] of x (``shape``
    (B, S, d)), given by ``tokens_on(r, rows, seqs)`` as (N_loc, d) on
    its device; it routes its N_loc = (B/dp)(S/T) tokens through
    ``router_on(r)`` with capacity C from N_loc (not from S) and packs an
    (E, C, d) send buffer.  The all-to-all hands rank u of the group
    slice u, (E/T, C, d), of every rank's buffer; rank u runs its E/T
    experts, ``experts_on(r, u, rows (E/T, T·C, d))``, over its tokens;
    the inverse exchange returns each rank its (E, C, d) outputs, which
    it combines with its gates into (B/dp, S/T, d), handed to
    ``put(rows, seqs, r, y)``.  A slice that stays on its device is a
    view, one that changes device a copy.  Returns each rank's aux loss
    on its device, in rank order (``with_aux``; else [])."""
    dp_axes, dps, T = layout
    B, S, d = shape
    E, k = cfg.num_experts, cfg.top_k
    E_l, B_l, S_l = E // T, B // dps, S // T
    N = B_l * S_l
    C = capacity(cfg, N)
    auxs = []
    for g in range(dps):
        coord = _coords(mesh, dp_axes, g)
        ranks = [_rank(mesh, dict(coord, model=t)) for t in range(T)]
        rows = slice(g * B_l, (g + 1) * B_l)
        routes, sends = [], []
        for t, r in enumerate(ranks):
            with rank_scope(r):
                dev = mesh.devices[r]
                xf = tokens_on(r, rows, slice(t * S_l, (t + 1) * S_l))
                gate_k, idx_k, pos_k, keep_k, probs, logits = route_local(
                    xf, router_on(r), k, C)
                xk = torch.where(keep_k[..., None], xf[:, None, :],
                                 torch.zeros((), dtype=dtype, device=dev))
                buf = torch.zeros((E, C, d), dtype=dtype, device=dev)
                buf.index_put_((idx_k.reshape(-1), pos_k.reshape(-1)),
                               xk.reshape(-1, d), accumulate=True)
                sends.append(buf.view(T, E_l, C, d))
                routes.append((gate_k, idx_k, pos_k, keep_k))
                if with_aux:
                    auxs.append(_aux(idx_k, probs, logits, E))
        # exchange: rank u's tokens are slice u of every rank's buffer,
        # laid out (E_l, T, C, d) as the reference's swapaxes
        outs = []
        for u, r in enumerate(ranks):
            with rank_scope(r):
                tokens = torch.stack([to_rank(s[u], mesh, r,
                                              path="all-to-all")
                                      for s in sends], 1)
                outs.append(experts_on(r, u, tokens.view(E_l, T * C, d))
                            .view(E_l, T, C, d))
        # the inverse exchange and each rank's combine
        for t, r in enumerate(ranks):
            with rank_scope(r):
                mine = torch.cat([to_rank(o[:, t], mesh, r,
                                          path="all-to-all") for o in outs])
                gate_k, idx_k, pos_k, keep_k = routes[t]
                picked = mine[idx_k, pos_k]                      # (N, k, d)
                w = (gate_k * keep_k).to(dtype)
                yl = (w[:, None, :] @ picked)[:, 0, :]
            put(rows, slice(t * S_l, (t + 1) * S_l), r,
                yl.view(B_l, S_l, d))
    return auxs


# ---------------------------------------------------------------------------
# a placed model's moe FFN
# ---------------------------------------------------------------------------

def _entry(axes: Sequence[str]):
    """The spec entry of a joint split over ``axes`` (None: none)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def placed_experts(p: MoEFFN, rows: torch.Tensor, rank: int,
                   mesh: DeviceMesh, experts: slice = slice(None),
                   ffn: slice = slice(None)) -> torch.Tensor:
    """:func:`expert_ffn` of a placed FFN on ``rank``: rows (E', n, d) of
    the experts ``experts`` through their SwiGLU restricted to the hidden
    columns ``ffn`` (a partial output, to be summed, where ``ffn`` is not
    all of them), each weight's slice taken onto the rank from the blocks
    that hold it (``launch.mesh.take``: the ZeRO-3 gather of its
    ``embed`` dimension over ``data``)."""
    dt = rows.dtype
    g = torch.bmm(rows, take(p.w_gate, rank, (experts, slice(None), ffn),
                             mesh=mesh).to(dt))
    u = torch.bmm(rows, take(p.w_up, rank, (experts, slice(None), ffn),
                             mesh=mesh).to(dt))
    return torch.bmm(F.silu(g) * u, take(p.w_down, rank, (experts, ffn),
                                         mesh=mesh).to(dt))


def _expert_ranks(p: MoEFFN, rows: torch.Tensor, home: int,
                  mesh: DeviceMesh) -> torch.Tensor:
    """The local path's experts for one batch group, whose capacity
    buffer rows (E, n, d) lies on the group's first rank ``home``, on
    the ranks of the group that hold the experts (the reference's
    ``act_experts`` / ``act_ffn`` constraints, ``moe.py:108-116``):

    * ``experts`` split over ``model`` (E divides it): rank t of the
      group runs the E/T experts of its block on their rows of the
      buffer, and the outputs are gathered back to ``home`` (each
      expert's output whole, so the combine that follows is the one
      device's arithmetic);
    * ``ffn`` split instead: every rank of the group runs every expert on
      its hidden columns (its columns of ``w_gate`` / ``w_up``, its rows of
      ``w_down``), and the partial outputs are summed on ``home`` in fp32;
    * neither: ``home`` runs every expert, the weights gathered whole.

    Returns the outputs (E, n, d) on ``home``."""
    e_axes, f_axes = spec_entry(p.w_gate, 0), spec_entry(p.w_gate, 2)
    axes = e_axes or f_axes
    if axes is None:
        return placed_experts(p, rows, home, mesh)
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    n = math.prod(mesh.axis_size(a) for a in names)
    E, F_ = rows.shape[0], p.w_gate.shape[2]
    coord = mesh.coords(home)
    outs = []
    for t in range(n):
        r = _rank(mesh, dict(coord, **_coords(mesh, names, t)))
        with rank_scope(r):
            if e_axes:
                sl = slice(t * E // n, (t + 1) * E // n)
                out = placed_experts(p, to_rank(rows[sl], mesh, r,
                                                path="all-to-all"),
                                     r, mesh, experts=sl)
            else:
                cols = slice(t * F_ // n, (t + 1) * F_ // n)
                out = placed_experts(p, to_rank(rows, mesh, r,
                                                path="all-to-all"),
                                     r, mesh, ffn=cols)
        outs.append(to_rank(out, mesh, home,
                            path="all-to-all" if e_axes else "sum"))
    if e_axes:
        return torch.cat(outs)
    return torch.stack(outs).sum(0, dtype=torch.float32).to(rows.dtype)


def _aux_sums(idx_k: torch.Tensor, probs: torch.Tensor,
              logits: torch.Tensor, E: int) -> torch.Tensor:
    """The sums :func:`_aux` takes means of, over the tokens of one batch
    group, in one fp32 tensor (2E + 2,): each expert's count of tokens that
    chose it, each expert's summed probability, the summed squared
    log-partition and the token count."""
    dims = tuple(range(idx_k.dim() - 1))
    n = torch.full((1,), float(math.prod(idx_k.shape[:-1])),
                   device=probs.device)
    return torch.cat([(F.one_hot(idx_k, E).sum(-2) > 0).float().sum(dims),
                      probs.sum(dims),
                      torch.logsumexp(logits, dim=-1).square().sum()[None],
                      n])


def _aux_of_sums(sums: torch.Tensor, E: int) -> torch.Tensor:
    """:func:`_aux` over every token from the groups' :func:`_aux_sums`
    added: the local path's aux over the whole batch."""
    n = sums[2 * E + 1]
    return E * (sums[:E] / n * (sums[E:2 * E] / n)).sum() + \
        1e-3 * sums[2 * E] / n


def _local_placed(p: MoEFFN, h: Sharded, cfg: ModelConfig,
                  auxs: Optional[list] = None) -> Sharded:
    """The local path over placed weights: each batch group of h (its
    batch block, the rows whole on the group's first rank) routes its
    rows there with capacity from S, and :func:`_expert_ranks` runs the
    experts where they lie; the output lies by batch groups.  With
    ``auxs``, each group's :func:`_aux_sums` are appended to it (on the
    group's first rank)."""
    mesh = h.sharding.mesh
    groups = Sharding(mesh, (h.sharding.spec[0], None, None))

    def one(b, sl, r):
        y, routed = _routed(take(h, r, (sl[0],)),
                            take(p.router, r, mesh=mesh), cfg,
                            lambda rows: _expert_ranks(p, rows, r, mesh))
        if auxs is not None:
            auxs.append(_aux_sums(*routed, cfg.num_experts))
        return y

    return map_blocks(groups, h.shape, one)


def _fsdp_placed(p: MoEFFN, h: Sharded, cfg: ModelConfig,
                 auxs: Optional[list] = None) -> Sharded:
    """The FSDP path over placed weights: the batch shards over
    :func:`fsdp_batch_axes`, and each shard's rank routes its rows and
    runs every expert, the weights gathered whole there (the reference's
    ``in_specs P()``).  With ``auxs``, each shard's aux loss is appended
    to it (on the shard's rank)."""
    mesh = h.sharding.mesh
    sh = Sharding(mesh, (_entry(fsdp_batch_axes(mesh, h.shape[0])), None,
                         None))

    def one(b, sl, r):
        y, routed = _routed(take(h, r, (sl[0],), path="moe"),
                            take(p.router, r, mesh=mesh), cfg,
                            lambda rows: placed_experts(p, rows, r, mesh))
        if auxs is not None:
            auxs.append(_aux(*routed, cfg.num_experts))
        return y

    return map_blocks(sh, h.shape, one)


def _a2a_placed(p: MoEFFN, h: Sharded, cfg: ModelConfig,
                layout, auxs: Optional[list] = None) -> Sharded:
    """The all-to-all over placed weights (:func:`_a2a`): rank (g, t)
    routes its own block of h where it lies (h laid out by ``("batch",
    "act_seq_tp", None)`` is the exchange's token shards; another layout
    is taken into them), with the router gathered there, and rank u runs
    the E/T experts of its ``model`` block, gathered over ``data``.  The
    output lies by the token shards.  With ``auxs``, each rank's aux loss
    is appended to it (on its rank)."""
    mesh = h.sharding.mesh
    E_l = cfg.num_experts // layout[2]
    d = h.shape[2]
    sh = Sharding(mesh, (_entry(layout[0]), "model", None))
    blocks = {}

    def put(rows, seqs, r, yl):
        blocks[sh.block_of(r)] = yl

    got = _a2a(cfg, mesh, layout, h.shape, h.dtype,
               lambda r, rows, seqs: take(h, r, (rows, seqs),
                                          path="all-to-all").reshape(-1, d),
               lambda r: take(p.router, r, mesh=mesh),
               lambda r, u, rows: placed_experts(
                   p, rows, r, mesh, experts=slice(u * E_l, (u + 1) * E_l)),
               put, with_aux=auxs is not None)
    if auxs is not None:
        auxs.extend(got)
    return Sharded(sh, h.shape, blocks)


def moe_ffn_placed(p: MoEFFN, h: Sharded, cfg: ModelConfig,
                   out: Sharding, with_aux: bool = False):
    """The moe FFN of a placed model (``weights.place_params``, or a
    training step's placed bf16 views) on the normed residual h (B, S, d),
    laid out by ``out``: the path :func:`moe_path` names for h's shape
    over ``out.mesh`` (counted in :data:`PATH_COUNTS`, or in
    :data:`RECOMPUTE_COUNTS` when backward recomputes it), each rank
    computing with the experts it holds, and the shared experts by
    ``models/common.py swiglu_mlp_placed`` (``w_gate`` / ``w_up``
    column-parallel, ``w_down`` row-parallel with the sum over
    ``model``).  Returns y; with ``with_aux`` (training) (y, the aux loss
    fp32 on the mesh's first rank, each path's as the reference's).

    * ``"a2a"`` (:func:`_a2a_placed`): each rank routes its token shard
      in place and runs its E/T experts; aux is the sum of the ranks'
      over ``T·dp`` (the reference's ``psum / n_dev``);
    * ``"local"`` (:func:`_local_placed`; decode, a batch the data axes
      do not divide, an odd length, or E % T): each batch group routes
      its rows on its first rank, its ``model`` ranks run their experts
      (or their ``ffn`` columns), and the outputs come back to that rank
      for the combine; aux is the whole batch's, from the groups' sums;
    * ``"fsdp"`` (:func:`_fsdp_placed`; a mesh without ``model``): each
      batch shard's rank runs every expert, gathered whole; aux is the
      mean of the shards' (the reference's ``pmean``)."""
    mesh = out.mesh
    path = moe_path(mesh, h.shape, cfg)
    in_backward = torch._C._current_graph_task_id() != -1
    (RECOMPUTE_COUNTS if in_backward else PATH_COUNTS)[path] += 1
    auxs = [] if with_aux else None
    if path == "a2a":
        layout = a2a_layout(mesh, h.shape, cfg)
        y = _a2a_placed(p, h, cfg, layout, auxs)
    elif path == "fsdp":
        y = _fsdp_placed(p, h, cfg, auxs)
    else:
        y = _local_placed(p, h, cfg, auxs)
    y = relayout(y, out)
    if p.shared is not None:
        y = blockwise(torch.add, y, swiglu_mlp_placed(
            h, p.shared.w_gate, p.shared.w_up, p.shared.w_down, out))
    if not with_aux:
        return y
    with rank_scope(0):
        on0 = [to_rank(a, mesh, 0, path="moe") for a in auxs]
        if path == "a2a":
            aux = torch.stack(on0).sum() / (layout[1] * layout[2])
        elif path == "fsdp":
            aux = torch.stack(on0).mean()
        else:
            aux = _aux_of_sums(torch.stack(on0).sum(0), cfg.num_experts)
    return y, aux


__all__ = ["CAPACITY_FACTOR", "PATH_COUNTS", "RECOMPUTE_COUNTS",
           "ROUTE_HOOK", "MoEFFN", "RouteLog", "SwiGLU", "a2a_layout",
           "capacity", "expert_ffn", "fsdp_batch_axes", "moe_ffn",
           "moe_ffn_a2a", "moe_ffn_fsdp", "moe_ffn_local", "moe_ffn_placed",
           "moe_path", "placed_experts", "route", "route_local"]
