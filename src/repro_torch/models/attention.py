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
  O(Sq x Skv) softmax residuals; over a rank mesh one call per block of
  the layout the reference constrains q to, on the block's rank.  The
  reference trains through this function and never through a Pallas
  kernel; the port's training forward likewise calls no kernel
  (``models/transformer.py`` chooses by ``impl=``).

Decode attention is K2, called from models/paged.py; under a rank mesh
its per-rank partials meet in :func:`lse_combine`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (Sharding, assemble, rank_scope,
                                     to_rank, to_rank_of)
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
                      causal: bool = True,
                      prefix_len: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in
    q.dtype, through K3.  The kernel writes its output in (B, Sq, H, D)
    order, so the result is contiguous for the o-projection."""
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               prefix_len=prefix_len)
    return out.transpose(1, 2)


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


#: the logical axes of q that the reference's ``attention_train``
#: constrains it to, by strategy (``attention.py:102-122``): its heads
#: over ``model``, or its query positions
TRAIN_Q_AXES = {"heads": ("batch", None, "act_heads", None),
                "seq": ("batch", "act_seq_tp", None, None)}


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
                    pos: torch.Tensor, info: MaskInfo, mesh=None,
                    strategy: str = "heads",
                    kv_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention for training: q (B, S, H, D), k / v
    (B, S, KVH, D), pos (B, S), every key valid.

    Over a ``mesh`` of more than one rank, q splits by the spec that
    :data:`TRAIN_Q_AXES` ``[strategy]`` resolves to under the active rules
    (``sharding.rules.logical_to_spec`` with q's dims: a dim that its axes
    do not divide stays whole, as the reference's ``constrain``), and each
    distinct block runs :func:`flash_attention` on the device of the
    lowest rank that holds it: its batch rows, its query positions against
    every key of those rows (``"seq"``), its heads against the K/V heads
    they read (``"heads"``).  The outputs come back to q's device.  The
    function is the whole call's: attention of a row, position and head
    reads nothing of another."""
    kv_valid = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
    if mesh is None or mesh.size == 1:
        return flash_attention(q, k, v, pos, pos, kv_valid, info, kv_chunk)
    sh = Sharding(mesh, logical_to_spec(TRAIN_Q_AXES[strategy], mesh,
                                        dims=tuple(q.shape)))
    group = q.shape[2] // k.shape[2]
    outs = {}
    for block, rank in sh.owners().items():
        rows, seq, heads, _ = sh.slices(block, q.shape)
        with rank_scope(rank):
            o = flash_attention(*(
                to_rank(t, mesh, rank, path="attention") for t in (
                    q[rows, seq, heads], _kv_for(k[rows], heads, group),
                    _kv_for(v[rows], heads, group), pos[rows, seq],
                    pos[rows], kv_valid[rows])), info, kv_chunk)
        outs[block] = to_rank_of(o, q, path="attention")
    return assemble(outs, sh.counts(4))


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


__all__ = ["MaskInfo", "NEG_INF", "TRAIN_Q_AXES", "attention_train",
           "flash_attention", "lse_combine", "prefill_attention"]
