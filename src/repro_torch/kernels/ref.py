"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in straightforward
tensor code.  They are the execution path for CPU tensors (the CPU tests
hold them against the JAX package's oracles in ``repro/kernels/ref.py``),
and ``chip_smoke.py`` holds every kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opcodes import (BITWISE_OPS, OP_AND, OP_CROSS_POOL_COPY,
                                      OP_OR, OP_ZERO_INIT, PLAIN_COPY_OPS,
                                      opspec)
# K4's plain version is the model-level intra-chunk term that training runs
# (the reference's ``_ssd_intra_chunk_jnp``, the oracle of its kernel): one
# copy, kept in models/
from repro_torch.models.mamba2 import ssd_intra_chunk

NEG_INF = -1e30

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def as_primary(primary: Optional[Sequence[bool]],
               n_pools: int) -> Tuple[bool, ...]:
    """Normalise the per-pool role vector (``None`` = every pool primary)."""
    if primary is None:
        return tuple([True] * n_pools)
    if len(primary) != n_pools:
        raise ValueError(f"role vector {primary!r} for {n_pools} pools")
    return tuple(bool(p) for p in primary)


def address_space(sizes: Sequence[int]):
    """The global-id space of pools with these block counts: the
    prefix-sum bases, the total, and ``locate(gid) -> (pool, block)``
    (raises outside the space)."""
    bases, run = [], 0
    for n in sizes:
        bases.append(run)
        run += int(n)

    def locate(gid: int) -> Tuple[int, int]:
        if not 0 <= gid < run:
            raise ValueError(f"global id {gid} outside {run} blocks")
        for i in range(len(bases) - 1, -1, -1):
            if gid >= bases[i]:
                return i, gid - bases[i]

    return tuple(bases), run, locate


def pool_dead(t: torch.Tensor) -> bool:
    """Has ``t``'s storage been freed (``RowCloneEngine.kill_pool``)?  A
    dead pool keeps its shape over zero bytes."""
    return t.numel() > 0 and t.untyped_storage().nbytes() == 0


def require_live(pools: Sequence[torch.Tensor]) -> None:
    """Raise before any work when a pool's storage was freed: a kernel
    must never read or write through the freed (null) address."""
    for i, p in enumerate(pools):
        if pool_dead(p):
            raise RuntimeError(f"pool {i} of shape {tuple(p.shape)} has no "
                               "storage (killed): recover() restores it")


def int_view(t: torch.Tensor) -> torch.Tensor:
    """Same-itemsize integer view: AND/OR/NOT act on raw bit patterns."""
    return t.view(_INT_OF_SIZE[t.element_size()])


def fused_dispatch(pools: Sequence[torch.Tensor],
                   zero_blocks: Sequence[torch.Tensor], cmds, *,
                   block_axis: int = 0,
                   primary: Optional[Sequence[bool]] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Apply one flushed ``(m, 3)`` ``[opcode, src, dst]`` table to every
    pool, IN PLACE (the JAX version returns new arrays from donated ones).

    Semantics of ``repro/kernels/ref.py fused_dispatch``: every source is
    gathered from the PRE-flush state, then every destination is written.
    Plain opcodes move the block in every primary pool; cross-pool and
    bitwise rows name one ``(pool, block)`` by global ``base[pool] + block``
    id, so staging pools receive only rows that name them; bitwise rows pack
    their two sources as ``a * total + b``.  ``OP_NOP`` rows and rows with
    ``dst == -1`` are skipped.  Returns the pools."""
    pools = tuple(pools)
    require_live(pools)
    ba = block_axis
    primary = as_primary(primary, len(pools))
    _, total, locate = address_space([p.shape[ba] for p in pools])

    def block(p: int, i: int) -> torch.Tensor:
        return pools[p].select(ba, i)

    if isinstance(cmds, torch.Tensor):
        cmds = cmds.cpu().numpy()
    writes = []
    for op, s, d in np.asarray(cmds, np.int64).tolist():
        if op < 0 or d < 0:
            continue
        opspec(op)                           # unknown opcodes raise
        if op in PLAIN_COPY_OPS or op == OP_ZERO_INIT:
            for p in range(len(pools)):
                if not primary[p]:
                    continue
                val = (zero_blocks[p][0].to(pools[p].dtype)
                       if op == OP_ZERO_INIT else block(p, s).clone())
                writes.append((p, d, val))
        elif op == OP_CROSS_POOL_COPY:
            (ps, ls), (pd, ld) = locate(s), locate(d)
            writes.append((pd, ld, block(ps, ls).clone()))
        elif op in BITWISE_OPS:
            a, b = divmod(s, total)
            (pa, la), (pb, lb), (pd, ld) = locate(a), locate(b), locate(d)
            ai = int_view(block(pa, la))
            bi = int_view(block(pb, lb))
            r = ai & bi if op == OP_AND else (ai | bi if op == OP_OR
                                              else ~ai)
            writes.append((pd, ld, r.view(pools[pd].dtype)))
    for p, i, val in writes:
        block(p, i).copy_(val)
    return pools


def _ids(ids, device) -> torch.Tensor:
    """Block ids (numpy, list or tensor) as int64 on ``device``."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids, np.int64))
    return ids.to(device=device, dtype=torch.int64)


def _move(dst_pool: torch.Tensor, src_pool: torch.Tensor, ids,
          block_axis: int, through_fp32: bool = False) -> torch.Tensor:
    """``dst_pool[dst] = src_pool[src]`` along ``block_axis``, IN PLACE:
    every source is gathered from the pre-call state (clipped into range),
    then written; a ``dst`` outside ``[0, nblk)`` (the ``-1`` padding)
    skips its pair."""
    ids = _ids(ids, dst_pool.device).reshape(-1, 2)
    src, dst = ids[:, 0], ids[:, 1]
    keep = (dst >= 0) & (dst < dst_pool.shape[block_axis])
    src = src.clamp(0, src_pool.shape[block_axis] - 1)[keep]
    rows = src_pool.index_select(block_axis, src)
    if through_fp32:
        rows = rows.float() * 1.0
    dst_pool.index_copy_(block_axis, dst[keep], rows.to(dst_pool.dtype))
    return dst_pool


def fpm_copy(pool: torch.Tensor, ids, *, block_axis: int = 0
             ) -> torch.Tensor:
    """In-pool block copy ``pool[dst] = pool[src]`` for each ``[src, dst]``
    row of ``ids`` (``repro/kernels/ref.py fpm_copy``; for ``block_axis=1``
    the layer-stacked ``_fpm_axis1_jit`` of ``repro/core/rowclone.py``).
    Gather-then-scatter, in place; ``dst == -1`` skips.  Returns the pool."""
    return _move(pool, pool, ids, block_axis)


def fpm_copy_cross(dst_pool: torch.Tensor, src_pool: torch.Tensor, ids, *,
                   block_axis: int = 0) -> torch.Tensor:
    """Pool-to-pool block copy ``dst_pool[dst] = src_pool[src]``
    (``repro/kernels/ref.py fpm_copy_cross``, ``_cross_axis1_jit``), in
    place.  Returns ``dst_pool``."""
    return _move(dst_pool, src_pool, ids, block_axis)


def baseline_copy(pool: torch.Tensor, ids, *, block_axis: int = 0
                  ) -> torch.Tensor:
    """The copy RowClone replaces: :func:`fpm_copy` with every block
    round-tripping float32 arithmetic, the copy through the compute units
    (``repro/kernels/ref.py baseline_copy``, ``_baseline_axis1_jit``)."""
    return _move(pool, pool, ids, block_axis, through_fp32=True)


def zero_init(pool: torch.Tensor, ids, *, block_axis: int = 0
              ) -> torch.Tensor:
    """Zero the listed blocks, in place (``repro/kernels/ref.py
    zero_init``, ``_zero_axis1_jit``); ``ids`` (m,), ``-1`` skips.  The
    result equals copying the reserved all-zero block.  Returns the pool."""
    ids = _ids(ids, pool.device).reshape(-1)
    keep = (ids >= 0) & (ids < pool.shape[block_axis])
    return pool.index_fill_(block_axis, ids[keep], 0)


def psm_transfer(tables, rows, *, block_axis: int = 0) -> None:
    """The PSM transfer over a rank mesh, in place (the plain version of
    K7; the reference's global ``_psm_jit`` gather / scatter on ids
    ``rank * slab + local``).  ``tables``: pairs of per-rank slab lists
    (sources, destinations); ``rows`` (k, 5) ``[table, my, src, dst,
    hop]``, checked (kernels/psm_transfer.py ``check_rows``): each copies
    block ``src`` of rank ``my``'s source slab into block ``dst`` of rank
    ``(my + hop + n) % n``'s destination slab.  Every source is read
    (``index_select`` per source slab) before any block is written
    (``index_copy_`` per destination slab)."""
    r = np.asarray(rows, np.int64).reshape(-1, 5)
    if not len(r):
        return
    n = len(tables[0][0])
    tgt = (r[:, 1] + r[:, 4] + n) % n
    got = [None] * len(r)
    for (t, my), idx in _groups(zip(r[:, 0].tolist(), r[:, 1].tolist())):
        src = tables[t][0][my]
        blocks = src.index_select(
            block_axis, torch.as_tensor(r[idx, 2], device=src.device))
        for j, i in enumerate(idx):
            got[i] = blocks.narrow(block_axis, j, 1)
    for (t, g), idx in _groups(zip(r[:, 0].tolist(), tgt.tolist())):
        dst = tables[t][1][g]
        vals = torch.cat([got[i].to(dst.device) for i in idx], block_axis)
        dst.index_copy_(block_axis,
                        torch.as_tensor(r[idx, 3], device=dst.device), vals)


def _groups(keys):
    """``(key, [indices])`` for each distinct key, in first-seen order."""
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out.items()


def paged_attention_slab(q, k_slab, v_slab, share_mask, base, seq_lens, *,
                         page: int):
    """Decode attention of one query per sequence over a pool slab, all
    pairs (``repro/kernels/ref.py paged_attention_slab``).

    q (B, H, D); k_slab / v_slab (nblk, page, KVH, D); share_mask (nblk, B);
    base (nblk,); seq_lens (B,) including the current token.  Returns the
    unnormalised acc (B, H, D) and l, m (B, H), fp32; a sequence with no
    visible position gets m = -1e30, l = 0, acc = 0."""
    nblk, pg, KVH, D = k_slab.shape
    B, H, _ = q.shape
    group = H // KVH
    qg = q.to(k_slab.dtype).float().reshape(B, KVH, group, D)
    k = k_slab.float()
    v = v_slab.float()
    s = torch.einsum("bkgd,npkd->bnkgp", qg, k) * (D ** -0.5)
    pos = base.long()[:, None] + torch.arange(pg, device=q.device)[None, :]
    valid = (share_mask.T > 0)[:, :, None] & \
        (pos[None] < seq_lens.long()[:, None, None])          # (B, nblk, pg)
    vm = valid[:, :, None, None, :]
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=(1, 4))                                    # (B, KVH, g)
    p = torch.exp(s - m[:, None, :, :, None])
    p = torch.where(vm, p, torch.zeros_like(p))
    l = p.sum(dim=(1, 4))
    acc = torch.einsum("bnkgp,npkd->bkgd", p, v)
    return acc.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H)


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0,
                    q_offset: int = 0):
    """Prefill attention, q (B, H, Sq, D) against k / v (B, KVH, Skv, D):
    causal plus the prefix-LM exception, GQA ``h // group``, fp32 softmax,
    output in ``q.dtype``; a fully masked row gives 0
    (``repro/kernels/flash_attention.py``).  ``q_offset``: the position
    of q's first row among the keys (a block of query rows; the causal
    rule is key column <= query row + q_offset)."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * (D ** -0.5)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = cols <= rows + q_offset
        if prefix_len:
            ok = ok | (cols < prefix_len)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vv) / l.clamp_min(1e-30)).to(q.dtype)


def ssd_ref(x, dt, A, B_mat, C_mat, D_skip):
    """Naive token-by-token state-space recurrence (``repro/kernels/ref.py
    ssd_ref``), the oracle of the chunked path.  x (B, S, H, P); dt
    (B, S, H) > 0; A (H,) < 0; B_mat, C_mat (B, S, N); D_skip (H,).
    Returns y (B, S, H, P) in ``x.dtype``."""
    Bb, S, H, P = x.shape
    N = B_mat.shape[-1]
    xf, Bf, Cf = x.float(), B_mat.float(), C_mat.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])                  # (B,H)
        dbx = torch.einsum("bhp,bn,bh->bhpn", xf[:, t], Bf[:, t], dt[:, t])
        h = h * decay[..., None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1) + xf * D_skip[None, None, :, None]
    return y.to(x.dtype)


__all__ = ["NEG_INF", "as_primary", "address_space", "int_view",
           "fused_dispatch",
           "fpm_copy", "fpm_copy_cross", "baseline_copy", "zero_init",
           "psm_transfer", "paged_attention_slab", "flash_attention",
           "ssd_intra_chunk", "ssd_ref"]
