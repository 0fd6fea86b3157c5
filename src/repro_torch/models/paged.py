"""Paged KV-cache device math (port of ``repro/models/paged.py``, one
device): the serving pools and the per-layer append-then-attend step."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.poolspec import PoolGroup, PoolSpec
from repro_torch.kernels import ops as kops


def make_serving_pools(num_layers: int, nblk: int, page: int, kv_heads: int,
                       head_dim: int, dtype: torch.dtype, device, *,
                       staging: bool = True,
                       stage_nblk: Optional[int] = None, ckpt_nblk: int = 0
                       ) -> Tuple[Dict[str, torch.Tensor], PoolGroup]:
    """Layer-stacked ``(L, nblk, page, KVH, D)`` K/V pools (block axis 1),
    plus (``staging=True``) their staging pools of ``stage_nblk`` slots
    (``None``: a full-size twin), where prefill pages park until
    ``OP_CROSS_POOL_COPY`` promotes them, plus (``ckpt_nblk > 0``)
    ``k_spill`` / ``v_spill`` pools of that many slots (``role="spill"``),
    where demoted blocks park.  Returns the pools and the
    :class:`PoolGroup` of the engine's address space (the reference's
    mesh placement hints are not ported: one device)."""
    block_shape = (num_layers, page, kv_heads, head_dim)

    def zeros(n):
        return torch.zeros((num_layers, n, page, kv_heads, head_dim),
                           dtype=dtype, device=device)

    pools = {"k": zeros(nblk), "v": zeros(nblk)}
    specs = [PoolSpec("k", nblk, block_shape, dtype),
             PoolSpec("v", nblk, block_shape, dtype)]
    extra = []
    if staging:
        extra.append(("stage", "staging",
                      nblk if stage_nblk is None else stage_nblk))
    if ckpt_nblk > 0:
        extra.append(("spill", "spill", ckpt_nblk))
    for suffix, role, n in extra:
        for twin in ("k", "v"):
            name = f"{twin}_{suffix}"
            pools[name] = zeros(n)
            specs.append(PoolSpec(name, n, block_shape, dtype, role=role,
                                  paired=twin))
    return pools, PoolGroup(specs)


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
    k_slab[blk_ids, offsets] = k_new[rows].to(k_slab.dtype)
    v_slab[blk_ids, offsets] = v_new[rows].to(v_slab.dtype)
    acc, l, _ = kops.paged_attention_slab(q, k_slab, v_slab, share_mask,
                                          base, seq_lens, page=page)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def identity_layout(batch: int, seq_len: int, page: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Block table, share mask and base of the contiguous layout where
    sequence b's j-th block is pool row ``b * nper + j`` (the reference's
    ``identity_layout`` on one device, ``dp = 1``).  Returns (block_table
    (B, nper) int32, share_mask (nblk, B) int8, base (nblk,) int32)."""
    nper = (seq_len + page - 1) // page
    nblk = batch * nper
    table = np.arange(nblk, dtype=np.int32).reshape(batch, nper)
    owner = np.repeat(np.arange(batch, dtype=np.int32), nper)
    base = np.tile(np.arange(nper, dtype=np.int32) * page, batch)
    mask = np.zeros((nblk, batch), np.int8)
    mask[np.arange(nblk), owner] = 1
    return table, mask, base


__all__ = ["make_serving_pools", "attend_append_local", "identity_layout"]
