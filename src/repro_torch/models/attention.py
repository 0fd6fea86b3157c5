"""Attention of the port's models (port of ``repro/models/attention.py``).

* Prefill: :func:`prefill_attention` hands the model's ``(B, S, H, D)``
  layout to K3 as ``(B, H, S, D)`` views, without a copy
  (kernels/flash_attention.py reads any 16-byte-aligned strides): a
  decoder's causal self-attention plus the prefix-LM exception, an
  encoder's non-causal self-attention, and an encoder-decoder's
  cross-attention over the encoder's frames.
* Training: :func:`attention_train` and :func:`flash_attention`, the
  reference's model-level online softmax over KV chunks, each chunk's body
  checkpointed so that backward recomputes its scores instead of keeping
  O(Sq x Skv) softmax residuals, on one device.  The
  reference trains through this function and never through a Pallas
  kernel; the port's training forward likewise calls no kernel
  (``models/transformer.py`` chooses by ``impl=``).

* Placed training: :func:`attention_train_placed`, :func:`flash_attention`
  once for each block of a placed model's q (laid out by
  :data:`PLACED_Q_AXES`, as the reference's ``constrain``), on the block's
  rank, over every K/V row of its batch block and the K/V heads its q
  heads read, taken from wherever they lie.
* Placed prefill: :func:`prefill_attention_placed`, K3 once for each
  block of a placed model's q, on the block's rank, by the strategy
  ``sharding.rules.attn_strategy`` picks: its heads with the K/V heads
  they read (``"heads"``), or its query rows over the K/V rows up to its
  last one or the prefix's end (``"seq"``, K3's ``q_offset`` with
  ``prefix_len``); every K/V row for an encoder or a cross-attention.

Decode attention is K2, called from models/paged.py; under a rank mesh
its per-rank partials meet in :func:`lse_combine`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (Sharded, Sharding, map_blocks, take,
                                     to_rank_of)
from repro_torch.models.common import checkpointed
from repro_torch.sharding.rules import logical_to_spec

NEG_INF = -1e30


class MaskInfo(NamedTuple):
    """The attention mask pattern.

    causal: the causal LM mask; prefix_len: key positions below it are
    visible to every query (PaliGemma's prefix-LM), 0 for pure causal.
    """
    causal: bool = True
    prefix_len: int = 0


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, prefix_len: int = 0,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in
    q.dtype, through K3 (``q_offset``: the position of q's first row, for
    a block of query rows).  The kernel writes its output in (B, Sq, H, D)
    order, so the result is contiguous for the o-projection."""
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               prefix_len=prefix_len, q_offset=q_offset)
    return out.transpose(1, 2)


#: the logical axes of a placed model's q in prefill and training, by
#: strategy (the reference's
#: ``attention_train`` constraints, ``attention.py:102-122``): its heads
#: over ``model``, or its query positions
PLACED_Q_AXES = {"heads": ("batch", None, "act_heads"),
                 "seq": ("batch", "act_seq_tp", None)}


def placed_qkv_shardings(mesh, strategy: str, B: int, S: int, H: int,
                         KVH: int) -> Tuple[Sharding, Sharding]:
    """The layouts of a placed prefill's post-RoPE q (B, S, H * D) and k
    (B, S, KVH * D): q by :data:`PLACED_Q_AXES` ``[strategy]`` (a dim the
    axes do not divide stays whole, as the reference's ``constrain``);
    k by its heads over ``model`` under ``"heads"`` where they divide
    (``act_kv_heads``), else by sequence rows like the residual, so that
    each rank rotates its own share.  Resolved on head counts, applied to
    the flat (heads x head dim) columns."""
    qspec = logical_to_spec(PLACED_Q_AXES[strategy], mesh, dims=(B, S, H))
    kspec = logical_to_spec(("batch", None, "act_kv_heads"), mesh,
                            dims=(B, S, KVH))
    if strategy == "seq" or kspec[2] is None:
        kspec = logical_to_spec(("batch", "act_seq_tp", None), mesh,
                                dims=(B, S, KVH))
    return Sharding(mesh, qspec), Sharding(mesh, kspec)


def prefill_attention_placed(q: Sharded, k: Sharded, v: Sharded, H: int,
                             KVH: int, D: int, *, causal: bool = True,
                             prefix_len: int = 0) -> Sharded:
    """Prefill attention of a placed model, each block of ``q`` (post-RoPE
    (B, S, H * D), laid out by :func:`placed_qkv_shardings`) on its owner
    through K3, with the K/V heads its q heads read, taken from ``k``
    (post-RoPE, (B, Skv, KVH * D)) and ``v`` wherever they lie.  Causal:
    a block of query rows ``[s0, s1)`` reads the K/V rows up to
    ``max(s1, prefix_len)`` (prefix keys past s1 are visible: the vlm's
    patches) and passes s0 as K3's ``q_offset``; ``causal=False`` (an
    encoder, a cross-attention with Skv != S): every block reads every
    K/V row.  Returns the output laid out as q."""
    group = H // KVH
    B, S, _ = q.shape
    Skv = k.shape[1]

    def one(b, sl, r):
        rows, seq, cols = sl
        s0, s1 = seq.indices(S)[:2]
        kv_end = min(max(s1, prefix_len), Skv) if causal else Skv
        h0, h1 = cols.start // D, cols.stop // D
        kv0, kv1 = h0 // group, (h1 - 1) // group + 1
        kv = [take(t, r, (rows, slice(0, kv_end),
                          slice(kv0 * D, kv1 * D)))
              .reshape(-1, kv_end, kv1 - kv0, D) for t in (k, v)]
        read = [h // group - kv0 for h in range(h0, h1)]
        per = (h1 - h0) // (kv1 - kv0)
        if (h1 - h0) % (kv1 - kv0) or read != [i // per for i in
                                               range(h1 - h0)]:
            # the block's q heads straddle a group unevenly: one K/V head
            # per q head
            idx = torch.as_tensor(read, device=kv[0].device)
            kv = [t.index_select(2, idx) for t in kv]
        qb = q.blocks[b].reshape(-1, s1 - s0, h1 - h0, D)
        o = prefill_attention(qb, *kv, causal=causal,
                              prefix_len=prefix_len if causal else 0,
                              q_offset=s0 if causal else 0)
        return o.reshape(qb.shape[0], s1 - s0, (h1 - h0) * D)

    return map_blocks(q.sharding, q.shape, one)


def _mask(pos_q: torch.Tensor, pos_kv: torch.Tensor, kv_valid: torch.Tensor,
          info: MaskInfo) -> torch.Tensor:
    """pos_q (B, Sq), pos_kv (B, Skv), kv_valid (B, Skv) bool ->
    (B, Sq, Skv) bool."""
    m = kv_valid[:, None, :]
    if info.causal:
        allowed = pos_q[:, :, None] >= pos_kv[:, None, :]
        if info.prefix_len:
            allowed = allowed | (pos_kv < info.prefix_len)[:, None, :]
        m = m & allowed
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_kv: torch.Tensor,
                    kv_valid: torch.Tensor, info: MaskInfo,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention, memory O(Sq x kv_chunk).

    q (B, Sq, H, D); k, v (B, Skv, KVH, D) with H % KVH == 0; Skv splits
    into ``max(Skv // kv_chunk, 1)`` equal chunks.  The products are fp32
    accumulations of the inputs' values (the reference's
    ``preferred_element_type=float32``), the probabilities are cast to
    v's dtype before the second.  Returns (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    group = H // KVH
    scale = D ** -0.5
    n_chunks = max(Skv // kv_chunk, 1)
    kv_chunk = Skv // n_chunks
    if kv_chunk * n_chunks != Skv:
        raise ValueError(f"{Skv} keys do not split into {n_chunks} equal "
                         "chunks")
    qg = q.reshape(B, Sq, KVH, group, D).float()

    def body(m, l, acc, kb, vb, pb, valid):
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float()) * scale
        msk = _mask(pos_q, pb, valid, info)                    # (B,Sq,c)
        s = torch.where(msk[:, :, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(vb.dtype).float(),
                          vb.float())
        return m_new, l_new, acc * corr[..., None] + pv

    m = torch.full((B, Sq, KVH, group), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KVH, group), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((B, Sq, KVH, group, D), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        m, l, acc = checkpointed(body, m, l, acc, k[:, sl], v[:, sl],
                                 pos_kv[:, sl], kv_valid[:, sl])
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _kv_for(k: torch.Tensor, heads: slice, group: int) -> torch.Tensor:
    """The K/V heads that q heads ``heads`` read (head h reads h // group):
    a slice where the block holds whole groups, else one K/V head per q
    head (the block's heads straddle a group)."""
    h0, h1 = heads.start, heads.stop
    if h0 % group == 0 and (h1 - h0) % group == 0:
        return k[:, :, h0 // group:h1 // group]
    idx = torch.arange(h0, h1, device=k.device) // group
    return k.index_select(2, idx)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, info: MaskInfo,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention for training on q's device: q (B, S, H,
    D), k / v (B, S, KVH, D), pos (B, S), every key valid
    (:func:`flash_attention`).  Over a mesh the training step runs
    :func:`attention_train_placed`."""
    kv_valid = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
    return flash_attention(q, k, v, pos, pos, kv_valid, info, kv_chunk)


def attention_train_placed(q: Sharded, k: Sharded, v: Sharded,
                           pos: Optional[Sharded], H: int, KVH: int, D: int,
                           info: MaskInfo, kv_chunk: int = 512) -> Sharded:
    """Training attention of a placed model (:func:`attention_train` by
    blocks): q post-RoPE (B, S, H * D), laid out by
    :func:`placed_qkv_shardings` (whose q layout is :data:`PLACED_Q_AXES`
    ``[strategy]``, the reference's ``attention_train`` constraint on the
    flat heads); k, v (B, Skv, KVH * D) in any
    layout.  Each block of q runs :func:`flash_attention` on its owner
    over every K/V row of its batch rows (masked as ``info`` says, at the
    positions ``pos`` (B, S) gives its query rows and the K/V rows; with
    ``info.causal`` False, ``pos`` may be None: every row is visible) and
    the K/V heads its q heads read.  Returns the output laid out as q.
    The function is the whole call's: a row, position and head of the
    output reads nothing of another."""
    group = H // KVH
    B, S, _ = q.shape
    Skv = k.shape[1]

    def one(b, sl, r):
        rows, seq, cols = sl
        s0, s1 = seq.indices(S)[:2]
        h0, h1 = cols.start // D, cols.stop // D
        kv0, kv1 = h0 // group, (h1 - 1) // group + 1
        kv = [_kv_for(take(t, r, (rows, slice(None),
                                  slice(kv0 * D, kv1 * D)))
                      .reshape(-1, Skv, kv1 - kv0, D),
                      slice(h0 - kv0 * group, h1 - kv0 * group), group)
              for t in (k, v)]
        qb = q.blocks[b].reshape(-1, s1 - s0, h1 - h0, D)
        Bb, dev = qb.shape[0], qb.device
        if info.causal:
            pq, pk = (take(pos, r, index, mesh=q.sharding.mesh)
                      for index in ((rows, seq), (rows,)))
        else:
            pq = torch.zeros((Bb, s1 - s0), dtype=torch.long, device=dev)
            pk = torch.zeros((Bb, Skv), dtype=torch.long, device=dev)
        valid = torch.ones((Bb, Skv), dtype=torch.bool, device=dev)
        o = flash_attention(qb, *kv, pq, pk, valid, info, kv_chunk)
        return o.reshape(Bb, s1 - s0, (h1 - h0) * D)

    return map_blocks(q.sharding, q.shape, one)


def lse_combine(accs: Sequence[torch.Tensor], ls: Sequence[torch.Tensor],
                ms: Sequence[torch.Tensor],
                home: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Combine the flash partials of several ranks (the reference's
    ``lse_combine``, whose ``pmax`` / ``psum`` run over a mesh axis): per
    rank acc (B, H, D), l and m (B, H), fp32.  Brings them to ``home``'s
    device (default the first partial's; under an op-cost walk, its rank)
    and combines in the reference's order: the max of ``m``, ``corr =
    exp(m - m_g)``, the sums of ``l * corr`` and of ``acc * corr``, then
    ``acc_g / max(l_g, 1e-30)``.  A rank that sees
    no position of a row holds ``m = -1e30, l = 0, acc = 0`` there (K2 and
    its plain version), so its ``corr`` underflows to 0; a row no rank
    sees comes out 0.  Plain tensor code, not a kernel."""
    home = accs[0] if home is None else home

    def to(x):
        return to_rank_of(x, home, path="lse_combine")

    m = torch.stack([to(x) for x in ms])
    m_g = m.amax(dim=0)
    corr = torch.exp(m - m_g)
    l_g = (torch.stack([to(x) for x in ls]) * corr).sum(dim=0)
    acc_g = (torch.stack([to(x) for x in accs])
             * corr[..., None]).sum(dim=0)
    return acc_g / l_g.clamp_min(1e-30)[..., None]


__all__ = ["MaskInfo", "NEG_INF", "PLACED_Q_AXES", "attention_train",
           "attention_train_placed", "flash_attention", "lse_combine",
           "placed_qkv_shardings", "prefill_attention",
           "prefill_attention_placed"]
