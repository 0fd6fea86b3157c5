"""Shared model blocks (port of ``repro/models/common.py``): RMS norm with
a ``(1 + scale)`` gain, split-half rotary embeddings, the SwiGLU MLP, the
embedding lookup and the sequence-chunked training cross-entropy.  Plain
tensor code: the JAX package computed these outside any Pallas kernel too.

The blocks of a placed model (``weights.place_params``) compute on
:class:`~repro_torch.launch.mesh.Sharded` activations, each block on the
rank that holds it, as the reference's GSPMD computes the same functions
on the weights ``tree_shardings`` placed: :func:`col_parallel` (a
product whose output columns split as the weight's, over ``model``),
:func:`row_parallel` (a product whose contraction splits over ``model``,
the partial products summed into the output's blocks), and over them the
norm, the SwiGLU MLP (``act_ffn``), the embedding lookup over the
``vocab``-split table, the logits by ``act_vocab`` slices and the training
cross-entropy by batch and vocabulary blocks
(:func:`chunked_softmax_xent_placed`).  A weight's ``embed`` (``data``)
dimension is gathered for its use and freed after (ZeRO-3).  Every placed
block carries gradients: a training step runs them under autograd, and
backward moves each block's grad back along the moves that fed it.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import (Sharded, Sharding, gather, map_blocks,
                                     rank_scope, scatter_sum, take, to_rank)
from repro_torch.sharding.rules import logical_to_spec


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, gain ``1 + scale``, result in ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Split-half rotation in fp32, result in ``x.dtype``."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU in ``x.dtype``; weights in the JAX layout ``(in, out)``."""
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    return (F.silu(g) * u) @ w_down.to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup, cast to the activation dtype."""
    return table[tokens].to(dtype)


def checkpointed(fn, *args, **kwargs):
    """``fn(*args)`` under ``torch.utils.checkpoint``: backward recomputes
    its activations instead of keeping them (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``; ``context_fn`` narrows
    it, ``models/transformer.py REMAT_POLICIES``).  The training forward
    draws no random numbers, so no RNG state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def chunked_softmax_xent(x_final: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy over the masked positions plus ``z_loss`` times
    the mean squared log-partition, over sequence chunks so that the full
    fp32 logits never exist at once.  x_final (B, S, D); w_out (D, V);
    labels / mask (B, S).  S is padded up to a multiple of the chunk count
    (``max(S // chunk, 1)``; the padding is masked); each chunk's logits
    are a bf16 x bf16 product read as fp32, and backward recomputes them
    (the reference's checkpointed scan body)."""
    B, S, D = x_final.shape
    n_chunks = max(S // chunk, 1)
    if S % n_chunks:
        pad = n_chunks - S % n_chunks
        x_final = F.pad(x_final, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    chunk = S // n_chunks
    labels = labels.long()
    mask = mask.float()

    def body(xb, lb, mb):
        logits = (xb.to(torch.bfloat16) @ w_out.to(torch.bfloat16)).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
        return ((lse - gold) * mb).sum(), (lse.square() * mb).sum()

    loss_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                   device=x_final.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ce, zl = checkpointed(body, x_final[:, sl], labels[:, sl],
                              mask[:, sl])
        loss_sum = loss_sum + ce
        z_sum = z_sum + zl
    denom = mask.sum().clamp_min(1.0)
    return loss_sum / denom + z_loss * z_sum / denom


# ---------------------------------------------------------------------------
# the blocks of a placed model
# ---------------------------------------------------------------------------

#: a placed weight: blocks on their ranks, or whole on the first rank
Placed = Union[torch.Tensor, Sharded]


def spec_entry(w: Placed, dim: int):
    """The mesh axes ``w``'s dimension ``dim`` splits over (None: whole)."""
    if not isinstance(w, Sharded) or dim >= len(w.sharding.spec):
        return None
    return w.sharding.spec[dim]


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def free_entry(entry, taken):
    """``entry``, or None where it shares a mesh axis with the entry
    ``taken`` (a spec splits a mesh axis over one dimension only: under
    ``FSDP_RULES`` a weight's ZeRO-3 dimension may take the axes the
    batch takes, and a product over it then gathers the weight whole
    instead)."""
    return None if set(_entry_axes(entry)) & set(_entry_axes(taken)) \
        else entry


def blockwise(fn, x: Sharded, *others: Sharded) -> Sharded:
    """``fn(block of x, blocks of others)`` block by block on the owners
    (``others`` laid out as ``x``)."""
    return map_blocks(x.sharding, x.shape, lambda b, sl, r: fn(
        x.blocks[b], *(o.blocks[b] for o in others)))


def rms_norm_placed(x: Sharded, scale: Placed, eps: float = 1e-5
                    ) -> Sharded:
    """:func:`rms_norm` of every block, the gain gathered on its rank."""
    mesh = x.sharding.mesh
    return map_blocks(x.sharding, x.shape, lambda b, sl, r: rms_norm(
        x.blocks[b], take(scale, r, mesh=mesh), eps))


def col_parallel(h: Sharded, *weights) -> Tuple[Sharded, ...]:
    """``h @ w (+ bias)`` for each ``(w, bias)`` of ``weights`` (bias None
    or placed): h (B, S, d) split by batch (any layout), w (d, n).  Each
    output (B, S, n) splits its batch as h and its columns as w's
    (``model``: the reference's ``qkv`` / ``ffn`` / ``act_ffn``); each
    block runs on its owner over h's rows of its batch block, gathered
    there once for every product (the all-gather before a
    column-parallel block), and w's columns of its block, whole over
    ``d``."""
    mesh = h.sharding.mesh
    B, S, _ = h.shape
    rows_on = {}

    def h_on(r, rows):
        key = (r, rows.start, rows.stop)
        if key not in rows_on:
            rows_on[key] = take(h, r, (rows,))
        return rows_on[key]

    def product(w, bias):
        def one(b, sl, r):
            rows, _, cols = sl
            hb = h_on(r, rows)
            y = hb @ take(w, r, (slice(None), cols), mesh=mesh).to(hb.dtype)
            if bias is not None:
                y = y + take(bias, r, (cols,), mesh=mesh).to(hb.dtype)
            return y

        sh = Sharding(mesh, (h.sharding.spec[0], None, free_entry(
            spec_entry(w, 1), h.sharding.spec[0])))
        return map_blocks(sh, (B, S, w.shape[1]), one)

    return tuple(product(w, bias) for w, bias in weights)


def row_parallel(a: Placed, w: Placed, out: Sharding) -> Sharded:
    """``a @ w`` laid out by ``out``: a (B, S, k) in any layout (or whole on
    the mesh's first rank), w (k, d)
    with its rows split as its spec says (``model``: the reference's
    ``qkv`` / ``ffn`` rows of ``wo`` / ``w_down``).  Each rank multiplies
    its block of a's columns by its block of w's rows (the partial
    product of its batch block, all S rows), and the partials are summed
    into ``out``'s blocks (:func:`~repro_torch.launch.mesh.scatter_sum`:
    by sequence rows where ``out`` splits them)."""
    mesh = out.mesh
    B, S, k = a.shape
    psh = Sharding(mesh, (free_entry(spec_entry(w, 0), out.spec[0]),
                          out.spec[0], None, None))
    C = psh.counts(1)[0]
    kc = k // C

    def one(b, sl, r):
        cols = slice(b[0] * kc, (b[0] + 1) * kc)
        ab = take(a, r, (sl[1], slice(None), cols), mesh=mesh)
        return (ab @ take(w, r, (cols,), mesh=mesh).to(ab.dtype))[None]

    return scatter_sum(map_blocks(psh, (C, B, S, w.shape[1]), one), out,
                       a.dtype)


def swiglu_mlp_placed(h: Sharded, w_gate: Placed, w_up: Placed,
                      w_down: Placed, out: Sharding) -> Sharded:
    """:func:`swiglu_mlp` on placed weights: ``w_gate`` / ``w_up``
    column-parallel (the reference's ``act_ffn`` over ``model``),
    ``w_down`` row-parallel with the sum, the result laid out by
    ``out``."""
    g, u = col_parallel(h, (w_gate, None), (w_up, None))
    return row_parallel(blockwise(lambda gb, ub: F.silu(gb) * ub, g, u),
                        w_down, out)


def embed_placed(table: Placed, tokens: torch.Tensor, dtype: torch.dtype,
                 out: Sharding) -> Sharded:
    """:func:`embed` over the ``vocab``-split table: tokens (B, S) on the
    mesh's first rank; each rank looks up the tokens of its batch block
    that fall in its vocabulary block (0 elsewhere), and the sum over the
    vocabulary blocks gives each row, laid out by ``out`` over (B, S, d)
    (exact: one term of the sum is not 0)."""
    mesh = out.mesh
    V, d = table.shape
    B, S = tokens.shape
    psh = Sharding(mesh, (free_entry(spec_entry(table, 0), out.spec[0]),
                          out.spec[0], None, None))
    C = psh.counts(1)[0]
    vc = V // C

    def one(b, sl, r):
        local = take(tokens, r, (sl[1],), mesh=mesh) - b[0] * vc
        hit = (local >= 0) & (local < vc)
        rows = take(table, r, (slice(b[0] * vc, (b[0] + 1) * vc),),
                    mesh=mesh)[local.clamp(0, vc - 1)].to(dtype)
        return torch.where(hit[..., None], rows,
                           torch.zeros((), dtype=dtype,
                                       device=rows.device))[None]

    return scatter_sum(map_blocks(psh, (C, B, S, d), one), out, dtype)


def logits_placed(xn: Sharded, head: Placed, tied: bool) -> torch.Tensor:
    """The bf16 head product of xn (B, 1, d), each rank its batch block
    over its ``act_vocab`` slice of the head (``head``: the embedding
    (V, d) when ``tied``, else the (d, V) head), joined fp32 (B, V) on the
    mesh's first rank for sampling."""
    mesh = xn.sharding.mesh
    B = xn.shape[0]
    V = head.shape[0] if tied else head.shape[1]
    sh = Sharding(mesh, (xn.sharding.spec[0], None,
                         spec_entry(head, 0 if tied else 1)))

    def one(b, sl, r):
        rows, _, cols = sl
        w = take(head, r, (cols,), mesh=mesh).T if tied else \
            take(head, r, (slice(None), cols), mesh=mesh)
        return (take(xn, r, (rows,)).to(torch.bfloat16)
                @ w.to(torch.bfloat16)).float()

    return gather(map_blocks(sh, (B, 1, V), one), mesh.devices[0])[:, 0]


def _head_block(head: Placed, tied: bool, r: int, cols: slice, mesh
                ) -> torch.Tensor:
    """The head's vocabulary columns ``cols`` as (d, n) on rank ``r`` (the
    embedding (V, d) transposed when ``tied``)."""
    if tied:
        return take(head, r, (cols,), mesh=mesh).T
    return take(head, r, (slice(None), cols), mesh=mesh)


def chunked_softmax_xent_placed(x: Sharded, head: Placed, tied: bool,
                                labels, mask, offset: int = 0,
                                chunk: int = 512, z_loss: float = 1e-4
                                ) -> torch.Tensor:
    """:func:`chunked_softmax_xent` by blocks (the reference's logits
    constrained ``("batch", None, "act_vocab")``): x (B, offset + S, d)
    placed, its rows from ``offset`` on scored against ``labels`` / ``mask``
    (B, S), placed or whole; ``head`` the embedding (V, d) when ``tied``,
    else the (d, V) head.  Each rank of the logits' layout takes its batch
    block's rows and its vocabulary columns of the head, and for each
    sequence chunk (the reference's: ``max(S // chunk, 1)`` chunks, the
    last one shorter where they do not divide S) computes the bf16 logits
    read as fp32, their log-partition and the gold logit where its block
    holds the label, checkpointed (backward recomputes the logits).  The
    log-partitions of a batch block's vocabulary blocks are combined on
    its first rank (max, then the log of the summed exponentials, as
    ``attention.lse_combine``), the gold logit summed (one term is not 0),
    and the masked sums of the cross-entropy, the squared log-partition
    and the mask are added in fp32 on the mesh's first rank.  Returns the
    mean cross-entropy plus ``z_loss`` times the mean squared
    log-partition, fp32, on the mesh's first rank."""
    mesh = x.sharding.mesh
    B, S = labels.shape
    V = head.shape[0] if tied else head.shape[1]
    n_chunks = max(S // chunk, 1)
    chunk = -(-S // n_chunks)
    sh = Sharding(mesh, logical_to_spec(("batch", None, "act_vocab"), mesh,
                                        dims=(B, S, V)))
    counts = sh.counts(3)
    Bb, Vb = B // counts[0], V // counts[2]
    owners = sh.owners()

    def body(xb, w, lb, v0):
        logits = (xb.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
        local = lb.long() - v0
        hit = (local >= 0) & (local < w.shape[1])
        gold = torch.gather(logits, -1, local.clamp(0, w.shape[1] - 1)
                            [..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1), torch.where(
            hit, gold, torch.zeros((), device=gold.device))

    # each block's (log-partition, gold logit) of every chunk
    parts = {}
    for (bi, _, vj), r in owners.items():
        rows = slice(bi * Bb, (bi + 1) * Bb)
        cols = slice(vj * Vb, (vj + 1) * Vb)
        with rank_scope(r):
            w = _head_block(head, tied, r, cols, mesh)
            for c in range(n_chunks):
                s0, s1 = c * chunk, min((c + 1) * chunk, S)
                xb = take(x, r, (rows, slice(offset + s0, offset + s1)))
                lb = take(labels, r, (rows, slice(s0, s1)), mesh=mesh)
                parts[bi, vj, c] = checkpointed(body, xb, w, lb,
                                                vj * Vb)
    sums = []
    for bi in range(counts[0]):
        home = owners[bi, 0, 0]
        rows = slice(bi * Bb, (bi + 1) * Bb)
        with rank_scope(home):
            for c in range(n_chunks):
                s0, s1 = c * chunk, min((c + 1) * chunk, S)
                got = [[to_rank(t, mesh, home, path="loss")
                        for t in parts[bi, vj, c]] for vj in range(counts[2])]
                if len(got) == 1:
                    lse, gold = got[0]
                else:
                    lses = torch.stack([g[0] for g in got])
                    m = lses.amax(0).detach()
                    lse = m + torch.log(torch.exp(lses - m).sum(0))
                    gold = torch.stack([g[1] for g in got]).sum(0)
                mb = take(mask, home, (rows, slice(s0, s1)),
                          mesh=mesh).float()
                sums.append(torch.stack([((lse - gold) * mb).sum(),
                                         (lse.square() * mb).sum(),
                                         mb.sum()]))
    with rank_scope(0):
        total = torch.stack([to_rank(t, mesh, 0, path="loss")
                             for t in sums]).sum(0)
        denom = total[2].clamp_min(1.0)
        return total[0] / denom + z_loss * total[1] / denom


__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu_mlp",
           "embed", "checkpointed", "chunked_softmax_xent",
           "chunked_softmax_xent_placed", "Placed",
           "blockwise", "col_parallel", "embed_placed", "logits_placed",
           "free_entry", "rms_norm_placed", "row_parallel", "spec_entry",
           "swiglu_mlp_placed"]
