"""The work of one call of each kernel, from its arguments: the HBM bytes
it must move (each input read once, each output written once) and the
FLOPs it must do, beside the peaks of one H100 SXM (the NVIDIA data sheet,
dense).  ``chip_smoke.py``'s bound column, ``launch/mechanisms.py``'s
``bound_ms`` and the op-cost walk's kernel boundary
(``launch/op_cost.py``) all read them here.

Each rule takes what the call takes.  Where a tensor holds values (a host
table, a CUDA or CPU tensor) the rule counts what this call's data needs;
on ``meta`` tensors, which have none, the shape-only form counts:

* K1, K5a, K5b, K6 and K7: their tables are host arrays, so their rows
  are always read; a ``meta`` table counts each of its rows as a copy;
* K2: every block of the slab full, the declared layout of a serve state
  whose fill (the tokens each sequence holds after the step's append) is
  a multiple of the page (``fill=``, as ``make_serve_state`` declares it);
* K3 and K4: their work follows their shapes alone.

:data:`BOUNDARY` is the active walk's kernel boundary, or None: each entry
point of ``kernels/ops.py`` hands its call to it when one is set.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

#: peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
#: NVLink 4, each way, one card
NVLINK_BYTES_PER_S = 450e9

#: bytes a K1 move reads, by kind (COPY, ZERO, AND, OR, NOT)
K1_READS = (1, 0, 2, 2, 1)

#: the active op-cost walk's kernel boundary (``launch/op_cost.py``): a
#: callable ``(name, work, tensors, shaped) -> shaped()``, where
#: ``work(declared)`` gives the call's :class:`Work` (``declared``: the
#: walk's declared layout, ``{"fill": ...}``), ``tensors`` the call's
#: tensors (the first decides the rank it runs on) and ``shaped`` gives
#: the call's outputs (the plain version, or an in-place kernel's pools);
#: or None
BOUNDARY = None


class Work(NamedTuple):
    """What one kernel call must do: HBM bytes and FLOPs."""
    bytes: int
    flops: float = 0.0


def _has_values(*ts) -> bool:
    return not any(isinstance(t, torch.Tensor) and t.is_meta for t in ts)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def block_bytes(pool: torch.Tensor, block_axis: int) -> int:
    """Bytes of one block of ``pool``: every dimension but the block axis
    (a layer-stacked pool's block spans its layers)."""
    shape = list(pool.shape)
    del shape[block_axis]
    return math.prod(shape) * pool.element_size()


def block_move_bytes(rows: int, layers: int, page_bytes: int,
                     passes: int) -> int:
    """K5a / K5b (2 passes: read, write) and K6 (1: write) over ``rows``
    blocks of ``layers`` pages."""
    return passes * rows * layers * page_bytes


def k1_bytes(table, sizes: Sequence[int], primary, layers: int,
             page_bytes: int) -> int:
    """Bytes a K1 drain of ``table`` must move: each move reads its
    sources' pages once and writes its destination's, in every layer.  A
    ``meta`` table counts each row as one copy."""
    if not _has_values(table):
        return 2 * int(table.shape[0]) * layers * page_bytes
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels.ref import as_primary
    moves, _ = fd.plan_moves(_host(table), sizes,
                             as_primary(primary, len(sizes)))
    return int(sum(K1_READS[k] + 1 for k in moves[:, 0])) * layers * \
        page_bytes


def k1_work(pools: Sequence[torch.Tensor], table, *, block_axis: int = 0,
            primary=None) -> Work:
    """K1 over ``pools`` (block axis ``block_axis``) for one table."""
    p0 = pools[0]
    layers = int(p0.shape[0]) if block_axis == 1 else 1
    page = math.prod(p0.shape[block_axis + 1:]) * p0.element_size()
    sizes = [int(p.shape[block_axis]) for p in pools]
    return Work(k1_bytes(table, sizes, primary, layers, page))


def _live_rows(ids, col: int) -> int:
    """Rows of an id table whose column ``col`` is >= 0 (every row of a
    ``meta`` table)."""
    if not _has_values(ids):
        return int(ids.shape[0])
    a = _host(ids)
    a = a.reshape(len(a), -1) if a.size else a.reshape(0, 1)
    return int((a[:, col] >= 0).sum())


def k5_work(pool: torch.Tensor, ids, *, block_axis: int = 0) -> Work:
    """K5a or K5b: ``ids`` (m, 2) ``[src, dst]``; a live row reads one
    block and writes one."""
    return Work(block_move_bytes(_live_rows(ids, 1), 1,
                                 block_bytes(pool, block_axis), 2))


def k6_work(pool: torch.Tensor, ids, *, block_axis: int = 0) -> Work:
    """K6: ``ids`` (m,); a live row writes one zero block."""
    return Work(block_move_bytes(_live_rows(ids, 0), 1,
                                 block_bytes(pool, block_axis), 1))


def k7_work(slab: torch.Tensor, rows, *, block_axis: int = 0) -> Work:
    """K7: wide rows ``[table, my, src, dst, hop]``; a live row (src >=
    0) reads one block and writes one on its peer."""
    return Work(2 * _live_rows(rows, 2) * block_bytes(slab, block_axis))


def k2_slots(mask, base, lens, page: int) -> int:
    """K/V slots K2 must read: of each visible block, the slots below some
    reader's length (a shared block once, its longest reader's count)."""
    need = np.clip(lens[None, :] - base[:, None], 0, page) * (mask > 0)
    return int(need.max(1).sum())


def k2_work(q, k_slab, v_slab, share_mask, base, seq_lens, *, page: int,
            fill: Optional[int] = None) -> Work:
    """K2 over one slab: the visible K/V slots once (bf16 K and V), q, and
    the fp32 ``acc, l, m`` out.  FLOPs: ``4 D`` a head for each (reader,
    slot) pair.  On ``meta`` tensors ``fill`` (the declared tokens a
    sequence holds) must be a multiple of the page: every block of the
    slab is then full and read by one reader."""
    B, H, D = q.shape
    KVH = k_slab.shape[2]
    if _has_values(share_mask, base, seq_lens):
        mask, b, lens = (_host(t).astype(np.int64)
                         for t in (share_mask, base, seq_lens))
        slots = k2_slots(mask, b, lens, page)
        pairs = int((np.clip(lens[None, :] - b[:, None], 0, page)
                     * (mask > 0)).sum())
    else:
        if fill is None or fill % page:
            raise ValueError(f"K2's shape-only form needs a declared fill "
                             f"that the page {page} divides, not {fill}")
        slots = pairs = int(k_slab.shape[0]) * page
    kv = slots * KVH * D * k_slab.element_size() * 2
    return Work(kv + nbytes(q) + B * H * (D + 2) * 4, 4.0 * H * D * pairs)


def k3_pairs(Sq: int, Skv: int, causal: bool, prefix: int,
             q_offset: int = 0) -> int:
    """(query, key) pairs K3 visits: all Sq x Skv without the causal mask;
    with it, row r (at position r + q_offset) sees max(r + q_offset + 1,
    prefix) keys (at most Skv)."""
    if not causal:
        return Sq * Skv
    return int(np.minimum(np.maximum(np.arange(1, Sq + 1) + q_offset,
                                     prefix), Skv).sum())


def k3_work(q, k, v, *, causal: bool = True, prefix_len: int = 0,
            q_offset: int = 0) -> Work:
    """K3: q (B, H, Sq, D) read and its output written, k / v read once;
    ``4 D`` FLOPs a head for each visible (query, key) pair."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    return Work(2 * nbytes(q) + nbytes(k) + nbytes(v),
                4.0 * B * H * D * k3_pairs(Sq, Skv, causal, prefix_len,
                                           q_offset))


def k4_work(xb, dtb, cum, Bb, Cb) -> Work:
    """K4: xb (B, Q, H, P), dtb / cum (B, Q, H) fp32 and Bb / Cb (B, Q, N)
    read, the (B, Q, H, P) fp32 output written; ``2 Q^2 (N + P)`` FLOPs a
    chunk and head."""
    Bc, Q, H, P = xb.shape
    N = Bb.shape[-1]
    return Work(sum(nbytes(t) for t in (xb, dtb, cum, Bb, Cb))
                + Bc * Q * H * P * 4,
                2.0 * Q * Q * (N + P) * Bc * H)


__all__ = ["BF16_FLOPS", "BOUNDARY", "HBM_BYTES_PER_S", "K1_READS",
           "NVLINK_BYTES_PER_S", "Work", "block_bytes", "block_move_bytes",
           "k1_bytes", "k1_work", "k2_slots", "k2_work", "k3_pairs",
           "k3_work", "k4_work", "k5_work", "k6_work", "k7_work", "nbytes"]
