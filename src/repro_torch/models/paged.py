"""Paged KV-cache device math (port of ``repro/models/paged.py``): the
serving pools, the mesh arithmetic of a sharded decode batch, and the
per-layer append-then-attend step.

Under a :class:`~repro_torch.launch.mesh.DeviceMesh` of more than one rank
every K/V pool is held as one slab per rank (``RowCloneEngine.slabs``).
The decode batch shards over the mesh's (pod, data) axes when the cache
pins each sequence's blocks inside its group's slabs (local share-mask
columns); each rank then appends the tokens that land in its slab, runs K2
over its slab with its group's queries, and the partials are LSE-combined
over the ranks of the group (:func:`~repro_torch.models.attention
.lse_combine`).  Otherwise the batch is replicated: every rank serves
every sequence and the combine spans all ranks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.poolspec import PoolGroup, PoolSpec
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (DeviceMesh, pool_shard_axes,
                                     pool_shard_ranks, rank_scope)
from repro_torch.models.attention import lse_combine

#: the hint of every sharded serving pool (the reference's)
POOL_HINT = ("pod", "data", "model")


# ---------------------------------------------------------------------------
# the mesh arithmetic of a sharded decode batch
# ---------------------------------------------------------------------------

def batch_shard_axes(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """Mesh axes the decode batch shards over: the (pod, data) subset when
    its size divides ``batch``, else () (a replicated batch)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    size = math.prod(mesh.axis_size(a) for a in dp)
    return dp if dp and batch % size == 0 else ()


def batch_shard_count(mesh: Optional[DeviceMesh], batch: int) -> int:
    """Groups the decode batch splits into (1: replicated, or no mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.axis_size(a) for a in batch_shard_axes(mesh, batch))


def combine_axes(mesh: DeviceMesh, batch_axes: Tuple[str, ...]
                 ) -> Tuple[str, ...]:
    """Pool axes over which decode partials are LSE-combined, given the
    axes the batch actually shards over."""
    bs = set(batch_axes)
    return tuple(a for a in pool_shard_axes(mesh) if a not in bs)


# ---------------------------------------------------------------------------
# pool construction
# ---------------------------------------------------------------------------

def make_serving_pools(num_layers: int, nblk: int, page: int, kv_heads: int,
                       head_dim: int, dtype: torch.dtype, device, *,
                       staging: bool = True,
                       stage_nblk: Optional[int] = None,
                       replicate_staging: bool = False, ckpt_nblk: int = 0,
                       replicate_ckpt: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], PoolGroup]:
    """Layer-stacked ``(L, nblk, page, KVH, D)`` K/V pools (block axis 1),
    plus (``staging=True``) their staging pools of ``stage_nblk`` slots
    (``None``: a full-size twin), where prefill pages park until
    ``OP_CROSS_POOL_COPY`` promotes them, plus (``ckpt_nblk > 0``)
    ``k_spill`` / ``v_spill`` pools of that many slots (``role="spill"``),
    where checkpoint windows and demoted blocks park.  Every spec carries
    the reference's placement hint: K/V shard over ``("pod", "data",
    "model")``; ``replicate_staging`` / ``replicate_ckpt`` hold the ring /
    the spill pools whole on every rank (the hint ``()``), for a size the
    shard count does not divide.  Returns the pools and the
    :class:`PoolGroup` of the engine's address space."""
    block_shape = (num_layers, page, kv_heads, head_dim)

    def zeros(n):
        return torch.zeros((num_layers, n, page, kv_heads, head_dim),
                           dtype=dtype, device=device)

    pools = {"k": zeros(nblk), "v": zeros(nblk)}
    specs = [PoolSpec("k", nblk, block_shape, dtype, sharding=POOL_HINT),
             PoolSpec("v", nblk, block_shape, dtype, sharding=POOL_HINT)]
    extra = []
    if staging:
        extra.append(("stage", "staging",
                      nblk if stage_nblk is None else stage_nblk,
                      replicate_staging))
    if ckpt_nblk > 0:
        extra.append(("spill", "spill", ckpt_nblk, replicate_ckpt))
    for suffix, role, n, replicate in extra:
        for twin in ("k", "v"):
            name = f"{twin}_{suffix}"
            pools[name] = zeros(n)
            specs.append(PoolSpec(name, n, block_shape, dtype, role=role,
                                  paired=twin,
                                  sharding=() if replicate else POOL_HINT))
    return pools, PoolGroup(specs)


# ---------------------------------------------------------------------------
# the per-layer decode step
# ---------------------------------------------------------------------------

def rank_appends(rows: torch.Tensor, blk_ids: torch.Tensor,
                 offsets: torch.Tensor, slab_sizes: Sequence[int]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Split a step's appends (the batch ``rows`` holding a sequence, the
    GLOBAL block id and the offset of each one's token) by the slab that
    holds the block: per slab, in shard order, (rows, slab-local block
    ids, offsets).  The local id is ``blk - start`` of the slab, as the
    reference's ``_slab_offset``.  One host sync a step, on the counts."""
    if len(slab_sizes) == 1:
        return [(rows, blk_ids, offsets)]
    starts = torch.as_tensor(np.cumsum([0, *slab_sizes[:-1]]),
                             device=blk_ids.device)
    rank = torch.bucketize(blk_ids, starts[1:], right=True)
    order = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank, minlength=len(slab_sizes)).tolist()
    local = blk_ids - starts[rank]
    return list(zip(*(t[order].split(counts)
                      for t in (rows, local, offsets))))


def attend_append_local(q, k_new, v_new, k_slab, v_slab, rows, blk_ids,
                        offsets, share_mask, base, seq_lens, *, page: int):
    """Write this step's K/V into its block, IN PLACE (the JAX version
    returns updated slabs), then attend over the slab.

    q (B, H, D); k_new / v_new (B, KVH, D); k_slab / v_slab
    (nblk, page, KVH, D); ``rows`` (n,) the batch slots that hold a
    sequence and ``blk_ids`` / ``offsets`` (n,) where their token lands
    (the JAX version drops the -1 ids of empty slots in its scatter; the
    caller drops them here, once per step); seq_lens (B,) including the
    new token.  Returns the normalised output (B, H, D) in q.dtype."""
    acc, l, _ = _append_partial(q, k_new, v_new, k_slab, v_slab, rows,
                                blk_ids, offsets, share_mask, base,
                                seq_lens, page)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _append_partial(q, k_new, v_new, k_slab, v_slab, rows, blk_ids, offsets,
                    share_mask, base, seq_lens, page):
    """Append into one slab in place, then K2's partials over it, on the
    slab's device."""
    dev = k_slab.device
    k_slab[blk_ids.to(dev), offsets.to(dev)] = \
        k_new[rows].to(dev, k_slab.dtype)
    v_slab[blk_ids.to(dev), offsets.to(dev)] = \
        v_new[rows].to(dev, v_slab.dtype)
    return kops.paged_attention_slab(
        q.to(dev), k_slab, v_slab, share_mask.to(dev), base.to(dev),
        seq_lens.to(dev), page=page)


def paged_attend_append(mesh: Optional[DeviceMesh], q, k_new, v_new,
                        k_slabs: Sequence[torch.Tensor],
                        v_slabs: Sequence[torch.Tensor], appends,
                        share_mask, base, seq_lens, *, page: int):
    """Append this step's K/V then attend over the paged cache (the
    reference's ``paged_attend_append``).

    ``k_slabs`` / ``v_slabs``: one layer's slab on each rank, in shard
    order, each (slab, page, KVH, D) (one whole pool without a mesh);
    ``appends``: :func:`rank_appends` of the step; q (B, H, D), k_new /
    v_new (B, KVH, D) on the model's device; share_mask (nblk, cols) int8,
    base (nblk,) and seq_lens (B,) (including the new token) over the
    GLOBAL block ids.  The column count of ``share_mask`` is the
    batch-sharding contract: ``B // dp`` local columns shard the batch
    over (pod, data) (every sequence's blocks in its group's slabs) and
    combine over the group's ranks; ``B`` global columns replicate the
    batch and combine over every rank.  Without a combine axis left (a
    ``("data",)`` mesh) each rank normalises its own rows.  Each rank's
    K2 call launches the kernel on CUDA tensors (or raises).  Returns the
    output (B, H, D) in q.dtype on q's device."""
    if mesh is None or mesh.size == 1:
        (rows, ids, offs), = appends
        return attend_append_local(q, k_new, v_new, k_slabs[0], v_slabs[0],
                                   rows, ids, offs, share_mask, base,
                                   seq_lens, page=page)
    B = q.shape[0]
    n = len(k_slabs)
    dp = batch_shard_count(mesh, B)
    if share_mask.shape[1] != B // dp:
        # global columns: the placement is not group-aligned, replicate
        dp = 1
    if share_mask.shape[1] != B // dp:
        raise ValueError(f"share mask of {share_mask.shape[1]} columns for "
                         f"a batch of {B} over {dp} groups")
    bl, per = B // dp, n // dp
    ranks = pool_shard_ranks(mesh)
    outs, start = [], 0
    for g in range(dp):
        rs = slice(g * bl, (g + 1) * bl)
        parts = []
        for r in range(g * per, (g + 1) * per):
            ns = k_slabs[r].shape[0]
            rows, ids, offs = appends[r]
            with rank_scope(ranks[r]):
                parts.append(_append_partial(
                    q[rs], k_new, v_new, k_slabs[r], v_slabs[r], rows, ids,
                    offs, share_mask[start:start + ns],
                    base[start:start + ns], seq_lens[rs], page))
            start += ns
        accs, ls, ms = zip(*parts)
        outs.append(lse_combine(accs, ls, ms, home=q))
    return torch.cat(outs).to(q.dtype)


# ---------------------------------------------------------------------------
# contiguous "identity" allocation used by the facade's prefill
# ---------------------------------------------------------------------------

def identity_layout(batch: int, seq_len: int, page: int, dp: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Block table, share mask and base of the contiguous layout where
    sequence b's j-th block is pool row ``b * nper + j``.  Returns
    (block_table (B, nper) int32, share_mask (nblk, B // dp) int8, base
    (nblk,) int32): the mask columns are LOCAL (``b % (B // dp)``) when
    the batch shards ``dp`` ways, global otherwise."""
    nper = (seq_len + page - 1) // page
    nblk = batch * nper
    table = np.arange(nblk, dtype=np.int32).reshape(batch, nper)
    owner = np.repeat(np.arange(batch, dtype=np.int32), nper)
    base = np.tile(np.arange(nper, dtype=np.int32) * page, batch)
    b_local = batch // dp if dp > 1 and batch % dp == 0 else batch
    mask = np.zeros((nblk, b_local), np.int8)
    mask[np.arange(nblk), owner % b_local] = 1
    return table, mask, base


__all__ = ["POOL_HINT", "attend_append_local", "batch_shard_axes",
           "batch_shard_count", "combine_axes", "identity_layout",
           "make_serving_pools", "paged_attend_append", "rank_appends"]
