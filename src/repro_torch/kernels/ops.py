"""Public entries of the port's kernels — the one resolution rule.

Every op runs its CUDA kernel for tensors on the card and its plain PyTorch
version (kernels/ref.py) for tensors on the CPU.  An explicit override
always wins: ``use_kernel=False`` on a call, or :func:`plain_versions` around
a whole code path, runs the plain version on the card (``chip_smoke.py``
compares the two that way).  ``use_kernel=True`` on a CPU tensor raises.
There is no fallback: on a CUDA tensor a kernel that does not build or
does not launch raises.

While an op-cost walk is active (``launch/op_cost.py``, over ``meta``
tensors only), each entry hands its call to the walk's kernel boundary
(``kernels/cost.py BOUNDARY``): the walk records the call's work by
``kernels/cost.py``'s rule and runs the plain version, uncounted, only to
give the outputs their shapes.  K1, K5a, K5b, K6 and K7 write their pools
in place, so their outputs are those pools and nothing runs (their plain
versions select rows by value, which ``meta`` tensors have not).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels.fused_dispatch import (COUNTER as FUSED_COUNTER,
                                                fused_dispatch_cuda,
                                                notify_launch,
                                                sharded_fused_dispatch)
from repro_torch.kernels.flash_attention import (COUNTER as FLASH_COUNTER,
                                                 flash_attention_cuda)
from repro_torch.kernels.fpm_copy import (COUNTER as FPM_COUNTER,
                                          CROSS_COUNTER, _live_pairs,
                                          fpm_copy_cross_cuda, fpm_copy_cuda,
                                          pair_waves)
from repro_torch.kernels.paged_attention import (COUNTER as PAGED_COUNTER,
                                                 paged_attention_slab_cuda)
from repro_torch.kernels.psm_transfer import (COUNTER as PSM_COUNTER,
                                              check_rows, psm_transfer_cuda,
                                              rank_rows)
from repro_torch.kernels.ssd_chunk import (COUNTER as SSD_COUNTER,
                                           ssd_intra_chunk_cuda)
from repro_torch.kernels.zero_init import (COUNTER as ZERO_COUNTER,
                                           zero_init_cuda)

#: every kernel's launch counter, by kernel name
KERNEL_COUNTERS = {c.name: c for c in (FUSED_COUNTER, PAGED_COUNTER,
                                       FLASH_COUNTER, SSD_COUNTER,
                                       FPM_COUNTER, CROSS_COUNTER,
                                       ZERO_COUNTER, PSM_COUNTER)}

_override: Optional[bool] = None


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run every op inside the block through its plain version, on any
    device (the explicit override)."""
    global _override
    prev, _override = _override, False
    try:
        yield
    finally:
        _override = prev


def use_kernel_for(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """The resolution rule: an explicit argument, else the active
    :func:`plain_versions` override, else "kernel iff on the card"."""
    if use_kernel is None:
        use_kernel = _override
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError("a CUDA kernel was requested for a CPU tensor")
    return bool(use_kernel)


def fused_dispatch(pools: Sequence[torch.Tensor],
                   zero_blocks: Sequence[torch.Tensor], cmds, *,
                   block_axis: int = 0, primary=None,
                   use_kernel: Optional[bool] = None):
    """Drain one flushed ``(m, 3)`` command table over every pool, IN
    PLACE, as one dispatch (see kernels/fused_dispatch.py).  Returns the
    pools."""
    if cost.BOUNDARY is not None:
        out = cost.BOUNDARY(
            "K1", lambda d: cost.k1_work(pools, cmds, block_axis=block_axis,
                                         primary=primary),
            list(pools) + list(zero_blocks), lambda: pools)
    elif use_kernel_for(pools[0], use_kernel):
        out = fused_dispatch_cuda(pools, cmds, block_axis=block_axis,
                                  primary=primary)
    else:
        out = ref.fused_dispatch(pools, zero_blocks, cmds,
                                 block_axis=block_axis, primary=primary)
    notify_launch(len(cmds), len(pools), "fused")
    return out


def fused_dispatch_sharded(slabs, plan, *, mesh, block_axis: int = 0,
                           primary=None, replicated=None,
                           use_kernel: Optional[bool] = None) -> None:
    """Drain one ``ShardPlan`` over the ranks' slabs (``slabs[p][r]``), in
    place: K7 for the hops and K1 per rank on CUDA slabs, their plain
    versions on CPU slabs (kernels/fused_dispatch.py
    ``sharded_fused_dispatch``); one ``fused_mesh`` dispatch."""
    sharded_fused_dispatch(slabs, plan, mesh=mesh, block_axis=block_axis,
                           primary=primary, replicated=replicated,
                           use_kernel=use_kernel_for(slabs[0][0],
                                                     use_kernel))


def fpm_copy(pool: torch.Tensor, ids, *, block_axis: int = 0,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """In-pool FPM block copy, in place.  ``ids``: (m, 2) ``[src, dst]``,
    ``dst = -1`` skips.  Returns the pool."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K5a", lambda d: cost.k5_work(pool, ids, block_axis=block_axis),
            [pool], lambda: pool)
    if use_kernel_for(pool, use_kernel):
        return fpm_copy_cuda(pool, ids, block_axis=block_axis)
    return ref.fpm_copy(pool, ids, block_axis=block_axis)


def fpm_copy_cross(dst_pool: torch.Tensor, src_pool: torch.Tensor, ids, *,
                   block_axis: int = 0,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Pool-to-pool block copy ``dst_pool[dst] = src_pool[src]``, in
    place.  Returns ``dst_pool``."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K5b", lambda d: cost.k5_work(dst_pool, ids,
                                          block_axis=block_axis),
            [dst_pool, src_pool], lambda: dst_pool)
    if use_kernel_for(dst_pool, use_kernel):
        return fpm_copy_cross_cuda(dst_pool, src_pool, ids,
                                   block_axis=block_axis)
    return ref.fpm_copy_cross(dst_pool, src_pool, ids, block_axis=block_axis)


def meminit_zero(pool: torch.Tensor, ids, *, block_axis: int = 0,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """BuZ: zero the blocks ``ids`` (m,), ``-1`` skips, in place — the
    reserved zero block's broadcast, which the kernel does as zero stores.
    Returns the pool."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K6", lambda d: cost.k6_work(pool, ids, block_axis=block_axis),
            [pool], lambda: pool)
    if use_kernel_for(pool, use_kernel):
        return zero_init_cuda(pool, ids, block_axis=block_axis)
    return ref.zero_init(pool, ids, block_axis=block_axis)


def baseline_copy(pool: torch.Tensor, ids, *, block_axis: int = 0
                  ) -> torch.Tensor:
    """The mechanism RowClone replaces: blocks round-trip float32
    arithmetic.  No kernel: the JAX package computes it outside Pallas."""
    return ref.baseline_copy(pool, ids, block_axis=block_axis)


def psm_transfer_rows(tables, rows, *, block_axis: int = 0,
                      use_kernel: Optional[bool] = None) -> int:
    """K7 over wide rows ``[table, my, src, dst, hop]`` (see
    kernels/psm_transfer.py): on CUDA slabs one C call per source card
    checks, plans and launches once; on CPU slabs :func:`check_rows`
    checks and the plain version moves.  In place.  Returns the launches
    (0 on the plain version)."""
    if cost.BOUNDARY is not None:
        slab = tables[0][0][0]
        cost.BOUNDARY(
            "K7", lambda d: cost.k7_work(slab, rows, block_axis=block_axis),
            [t for tb in tables for side in tb for t in side],
            lambda: check_rows(tables, rows, block_axis))
        return 0
    if use_kernel_for(tables[0][0][0], use_kernel):
        return psm_transfer_cuda(tables, rows, block_axis=block_axis)
    ref.psm_transfer(tables, check_rows(tables, rows, block_axis),
                     block_axis=block_axis)
    return 0


def psm_transfer(slabs: Sequence[torch.Tensor], ids, *,
                 dst_slabs: Optional[Sequence[torch.Tensor]] = None,
                 block_axis: int = 0,
                 use_kernel: Optional[bool] = None) -> Sequence[torch.Tensor]:
    """The PSM transfer over the ``n`` ranks' slabs, in place: ``ids``
    (n, m, 3) int, rank ``i``'s rows ``[src_local, dst_local, hop]`` at
    ``ids[i]`` (``src = -1`` skips); each copies block ``src_local`` of
    ``slabs[i]`` into block ``dst_local`` of rank ``(i + hop + n) % n``'s
    destination slab (``dst_slabs``, by default ``slabs``).  One launch
    serves every rank on one card.  Returns the destination slabs."""
    dst = list(slabs if dst_slabs is None else dst_slabs)
    psm_transfer_rows([(list(slabs), dst)], rank_rows(ids, len(slabs)),
                      block_axis=block_axis, use_kernel=use_kernel)
    return dst


def psm_copy(pool: torch.Tensor, ids, *, block_axis: int = 0,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Cross-slab (PSM) copy within one pool on one device, in place:
    K7 with one rank and hop 0, one launch per wave of
    :func:`~repro_torch.kernels.fpm_copy.pair_waves` (a later pair may
    overwrite an earlier pair's source; K7 takes no such pair in one
    call).  ``ids`` (m, 2) ``[src, dst]``, ``dst = -1`` skips, sources
    clipped into the pool as the plain version clips them.  Returns the
    pool."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K7", lambda d: cost.k5_work(pool, ids, block_axis=block_axis),
            [pool], lambda: pool)
    if not use_kernel_for(pool, use_kernel):
        return ref.fpm_copy(pool, ids, block_axis=block_axis)
    nblk = int(pool.shape[block_axis])
    live = _live_pairs(ids, nblk, nblk)
    waves = pair_waves(live)
    table = [([pool], [pool])]
    for w in range(int(waves.max()) + 1 if len(live) else 0):
        part = live[waves == w]
        rows = np.zeros((len(part), 5), np.int64)
        rows[:, 2:4] = part
        # in range (_live_pairs), one writer a block and no source another
        # pair of the wave writes (pair_waves): K7's contract holds
        psm_transfer_cuda(table, rows, block_axis=block_axis)
    return pool


def paged_attention_slab(q, k_slab, v_slab, share_mask, base, seq_lens, *,
                         page: int, use_kernel: Optional[bool] = None):
    """Decode attention over one pool slab: (acc, l, m), fp32."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K2", lambda d: cost.k2_work(q, k_slab, v_slab, share_mask, base,
                                         seq_lens, page=page,
                                         fill=d.get("fill")),
            [k_slab, v_slab, q, share_mask, base, seq_lens],
            lambda: ref.paged_attention_slab(q, k_slab, v_slab, share_mask,
                                             base, seq_lens, page=page))
    if use_kernel_for(q, use_kernel):
        return paged_attention_slab_cuda(q, k_slab, v_slab, share_mask, base,
                                         seq_lens, page=page)
    return ref.paged_attention_slab(q, k_slab, v_slab, share_mask, base,
                                    seq_lens, page=page)


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0,
                    use_kernel: Optional[bool] = None):
    """Prefill attention; q (B,H,Sq,D) against k/v (B,KVH,Skv,D):
    causal (key column <= query row, both from 0) with the prefix-LM
    exception, or non-causal (every key visible); Sq != Skv for an
    encoder-decoder's cross-attention."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K3", lambda d: cost.k3_work(q, k, v, causal=causal,
                                         prefix_len=prefix_len),
            [q, k, v], lambda: ref.flash_attention(q, k, v, causal=causal,
                                                   prefix_len=prefix_len))
    if use_kernel_for(q, use_kernel):
        return flash_attention_cuda(q, k, v, causal=causal,
                                    prefix_len=prefix_len)
    return ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)


def ssd_intra_chunk(xb, dtb, cum, Bb, Cb, *,
                    use_kernel: Optional[bool] = None):
    """The Mamba2 SSD intra-chunk term; xb (B,Q,H,P), dtb / cum (B,Q,H)
    fp32, Bb / Cb (B,Q,N) -> (B,Q,H,P) fp32."""
    if cost.BOUNDARY is not None:
        return cost.BOUNDARY(
            "K4", lambda d: cost.k4_work(xb, dtb, cum, Bb, Cb),
            [xb, dtb, cum, Bb, Cb],
            lambda: ref.ssd_intra_chunk(xb, dtb, cum, Bb, Cb))
    if use_kernel_for(xb, use_kernel):
        return ssd_intra_chunk_cuda(xb, dtb, cum, Bb, Cb)
    return ref.ssd_intra_chunk(xb, dtb, cum, Bb, Cb)


__all__ = ["KERNEL_COUNTERS", "plain_versions", "use_kernel_for",
           "fused_dispatch", "fused_dispatch_sharded", "fpm_copy",
           "fpm_copy_cross", "meminit_zero", "baseline_copy", "psm_transfer",
           "psm_transfer_rows", "psm_copy", "paged_attention_slab",
           "flash_attention", "ssd_intra_chunk"]
