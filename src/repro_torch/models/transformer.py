"""Decoder layer (port of ``repro/models/transformer.py``): GQA attention
block (with the QKV bias where the config sets ``qkv_bias``) + a SwiGLU MLP
(dense, vlm, encdec, the hybrid's shared block) or a mixture-of-experts FFN
(moe), for prefill and for one decode step over the paged pools.  An
encoder-decoder's decoder layer has a cross-attention block between the two
(``cross=True``), and its encoder layers are decoder layers run without the
causal mask.  Weights keep the JAX layout ``(in, out)``, so ``h @ w`` reads
the same in both packages.

The full-sequence functions serve prefill (K3, ``impl="pallas"``) and
training (``impl="jax"``: the model-level attention of models/attention.py
that the reference trains through); :func:`decoder_stack_train` is the
training stack on one device, each layer under a remat policy
(:data:`REMAT_POLICIES`), :func:`decoder_stack_train_placed` its
counterpart over a mesh, on placed views.

A layer whose weights ``weights.place_params`` placed (every serving
family's decoder layers, an encdec's encoder layers, the hybrid's shared
block) runs through :func:`decoder_layer_placed` (prefill) and
:func:`decoder_layer_decode_placed` (decode) on a
:class:`~repro_torch.launch.mesh.Sharded` residual: by sequence rows
over ``model`` (``act_seq_tp``) in prefill where they divide, by batch
over (``pod``, ``data``) in both; the q / k / v projections
column-parallel, ``wo`` and the MLP's ``w_down`` row-parallel with the sum
over ``model`` (``models/common.py``), a moe FFN by its mesh path with
each rank's experts where they lie (``moe.moe_ffn_placed``), prefill
attention by block (``attention.prefill_attention_placed``: causal with
the vlm's prefix, or non-causal for an encoder), an encdec's
cross-attention by block (:func:`cross_block_placed`; in decode over the
batch-split cross state), decode self-attention over the slabs as for an
unplaced model (``paged.paged_attend_append``).  A training step over a
mesh runs the same blocks on its placed bf16 views under autograd
(:func:`decoder_layer_train_placed`): the attention by
``attention.attention_train_placed``, a moe FFN with its aux loss."""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import (DeviceMesh, Sharded, Sharding,
                                     map_blocks, rank_scope, relayout, take)
from repro_torch.models.attention import (MaskInfo, attention_train,
                                         attention_train_placed,
                                         flash_attention,
                                         placed_qkv_shardings,
                                         prefill_attention,
                                         prefill_attention_placed)
from repro_torch.models.common import (apply_rope, blockwise, checkpointed,
                                       col_parallel, rms_norm,
                                       rms_norm_placed, row_parallel,
                                       swiglu_mlp, swiglu_mlp_placed)
from repro_torch.models.moe import MoEFFN, moe_ffn, moe_ffn_placed
from repro_torch.models.paged import paged_attend_append
from repro_torch.sharding.rules import attn_strategy


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class CrossAttention(nn.Module):
    """The cross-attention projections of an encoder-decoder's decoder
    layer (the reference's ``xattn``): ``wq`` reads the decoder's stream,
    ``wk`` / ``wv`` the encoder's output, ``wo`` writes back."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.wq = _param((d, cfg.q_dim), dtype, device)
        self.wk = _param((d, cfg.kv_dim), dtype, device)
        self.wv = _param((d, cfg.kv_dim), dtype, device)
        self.wo = _param((cfg.q_dim, d), dtype, device)


class DecoderLayer(nn.Module):
    """One decoder layer's weights.  Norm gains stay fp32; the projections
    (and the QKV biases ``bq`` / ``bk`` / ``bv`` of a ``qkv_bias`` config)
    are in the model dtype.  A dense layer holds its MLP's ``w_gate`` /
    ``w_up`` / ``w_down``, a moe layer a :class:`MoEFFN` as ``moe``; with
    ``cross=True`` it also holds the cross-attention's norm ``ln_x`` and a
    :class:`CrossAttention` as ``xattn``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param((d,), torch.float32, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.wq = _param((d, cfg.q_dim), dtype, device)
        self.wk = _param((d, cfg.kv_dim), dtype, device)
        self.wv = _param((d, cfg.kv_dim), dtype, device)
        self.wo = _param((cfg.q_dim, d), dtype, device)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = _param((cfg.q_dim,), dtype, device)
            self.bk = _param((cfg.kv_dim,), dtype, device)
            self.bv = _param((cfg.kv_dim,), dtype, device)
        if cfg.family == "moe":
            self.moe = MoEFFN(cfg, dtype, device)
        else:
            self.w_gate = _param((d, cfg.d_ff), dtype, device)
            self.w_up = _param((d, cfg.d_ff), dtype, device)
            self.w_down = _param((cfg.d_ff, d), dtype, device)
        if cross:
            self.ln_x = _param((d,), torch.float32, device)
            self.xattn = CrossAttention(cfg, dtype, device)

    def qkv(self, h: torch.Tensor):
        """Q, K, V projections in ``h``'s dtype, the biases added after the
        product (the reference's ``_qkv``)."""
        dt = h.dtype
        q, k, v = h @ self.wq.to(dt), h @ self.wk.to(dt), h @ self.wv.to(dt)
        if self.qkv_bias:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        return q, k, v

    def ffn(self, x: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[DeviceMesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (x + FFN(norm(x)), aux loss: 0 for dense).  A moe
        FFN takes the path ``mesh`` gives it (``moe.moe_ffn``); a dense one
        runs whole on x's device whatever the mesh."""
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.family == "moe":
            y, aux = moe_ffn(self.moe, h, cfg, mesh)
        else:
            y = swiglu_mlp(h, self.w_gate, self.w_up, self.w_down)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux


def _heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, d))


#: the attention each full-sequence function runs, by the name its
#: ``impl`` argument takes (the reference's ``ssd_chunked`` names):
#: ``"pallas"`` K3 (prefill), ``"jax"`` the model-level online softmax of
#: models/attention.py (training, as the reference trains)
ATTENTION_IMPLS = ("pallas", "jax")


def _self_attention(q, k, v, pos, prefix_len: int, causal: bool,
                    impl: str) -> torch.Tensor:
    if impl == "pallas":
        return prefill_attention(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    if impl == "jax":
        return attention_train(q, k, v, pos, MaskInfo(causal, prefix_len))
    raise ValueError(f"impl {impl!r}: one of {ATTENTION_IMPLS}")


def attn_block_train(layer: DecoderLayer, x: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, prefix_len: int = 0,
                     causal: bool = True, impl: str = "pallas"
                     ) -> Tuple[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """The self-attention block over a full sequence on x's device: x (B,
    S, d), pos (B, S).  Returns x plus the attention's output and this
    layer's post-RoPE (k, v), each (B, S, KVH, D)."""
    B, S, _ = x.shape
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    q, k, v = layer.qkv(h)
    q = apply_rope(_heads(q, cfg.num_heads, cfg.head_dim), pos,
                   cfg.rope_theta)
    k = apply_rope(_heads(k, cfg.num_kv_heads, cfg.head_dim), pos,
                   cfg.rope_theta)
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)
    o = _self_attention(q, k, v, pos, prefix_len, causal, impl)
    return x + o.reshape(B, S, cfg.q_dim) @ layer.wo.to(x.dtype), (k, v)


def cross_block_train(layer: DecoderLayer, x: torch.Tensor,
                      enc_out: torch.Tensor, cfg: ModelConfig,
                      impl: str = "pallas"
                      ) -> Tuple[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """The cross-attention block (the reference's ``cross_block_train``):
    the decoder's x (B, S, d) attends over the normed encoder output
    enc_out (B, S_src, d), no RoPE, every frame visible.  Returns x plus
    the block's output and the cross (k, v), each (B, S_src, KVH, D): the
    serve state's ``cross_k`` / ``cross_v`` of this layer."""
    B, S, _ = x.shape
    h = rms_norm(x, layer.ln_x, cfg.norm_eps)
    xa, dt = layer.xattn, h.dtype
    q = _heads(h @ xa.wq.to(dt), cfg.num_heads, cfg.head_dim)
    k = _heads(enc_out @ xa.wk.to(dt), cfg.num_kv_heads, cfg.head_dim)
    v = _heads(enc_out @ xa.wv.to(dt), cfg.num_kv_heads, cfg.head_dim)
    # every frame visible to every query: the reference's mask with zero
    # positions and every frame valid
    if impl == "jax":
        S_src, dev = enc_out.shape[1], x.device
        o = flash_attention(q, k, v,
                            torch.zeros((B, S), dtype=torch.long, device=dev),
                            torch.zeros((B, S_src), dtype=torch.long,
                                        device=dev),
                            torch.ones((B, S_src), dtype=torch.bool,
                                       device=dev),
                            MaskInfo(causal=False))
    else:
        o = _self_attention(q, k, v, None, 0, False, impl)
    return x + o.reshape(B, S, cfg.q_dim) @ xa.wo.to(x.dtype), (k, v)


def decoder_layer_train(layer: DecoderLayer, x: torch.Tensor,
                        pos: torch.Tensor, cfg: ModelConfig,
                        prefix_len: int = 0, causal: bool = True,
                        enc_out: Optional[torch.Tensor] = None,
                        impl: str = "pallas",
                        mesh: Optional[DeviceMesh] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence layer: x (B, S, d), pos (B, S); key positions below
    ``prefix_len`` are visible to every query (the vlm's patch prefix, the
    reference's ``MaskInfo.prefix_len``); ``causal=False`` makes every
    position visible to every query (an encoder layer); with ``enc_out``
    the cross-attention block runs after the self-attention.  ``impl``
    chooses the attention (:data:`ATTENTION_IMPLS`: K3 for prefill, the
    model-level function for training); ``mesh`` reaches the FFN (a moe
    layer's mesh path); the attention, the cross-attention and the rest
    run whole on x's device, the function GSPMD computes.  Returns the new x, the FFN's aux loss (fp32 scalar, 0
    for dense) and this layer's post-RoPE (k, v), each (B, S, KVH, D)."""
    x, kv = attn_block_train(layer, x, pos, cfg, prefix_len, causal, impl)
    if enc_out is not None:
        x, _ = cross_block_train(layer, x, enc_out, cfg, impl)
    x, aux = layer.ffn(x, cfg, mesh)
    return x, aux, kv


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``"dots"``: keep the outputs of the
    matrix products without batch dimensions (a token stream times a
    weight), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: the reference's remat policies: what a checkpointed layer keeps for
#: backward, as the ``context_fn`` of ``torch.utils.checkpoint``.
#: ``"none"`` keeps every activation (no checkpoint), ``"minimal"`` only
#: the layer's input (the reference's ``nothing_saveable``), ``"dots"`` the
#: products without batch dimensions (``checkpoint_dots_with_no_batch_
#: dims``); any other name checkpoints as ``"minimal"``, as the reference's
#: ``REMAT_POLICIES.get`` then gives no policy
REMAT_POLICIES = {
    "none": None,
    "minimal": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the remat policy named ``remat``."""
    if remat == "none":
        return fn(*args)
    return checkpointed(fn, *args, context_fn=REMAT_POLICIES.get(
        remat, noop_context_fn))


def decoder_stack_train(layers, x: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, info: MaskInfo,
                        enc_out: Optional[torch.Tensor] = None,
                        remat: str = "minimal"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of a decoder (or encoder) stack on one device:
    each layer under the remat policy ``remat``, the training attention
    (``impl="jax"``).  Over a mesh a stack runs
    :func:`decoder_stack_train_placed`.  Returns (x, the layers' aux
    losses summed)."""
    def body(layer, h):
        h, a, _ = decoder_layer_train(layer, h, pos, cfg, info.prefix_len,
                                      info.causal, enc_out, impl="jax")
        return h, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        x, a = remat_call(remat, body, layer, x)
        aux = aux + a
    return x, aux


def decoder_layer_decode(layer: DecoderLayer, x: torch.Tensor,
                         pos: torch.Tensor, k_slabs: Sequence[torch.Tensor],
                         v_slabs: Sequence[torch.Tensor], appends,
                         share_mask: torch.Tensor,
                         base: torch.Tensor, seq_lens_incl: torch.Tensor,
                         cfg: ModelConfig, page: int,
                         cross_kv: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None,
                         mesh: Optional[DeviceMesh] = None
                         ) -> torch.Tensor:
    """One token per sequence: x (B, d), pos (B,).  Appends this layer's
    new K/V into its slabs IN PLACE and attends over them
    (:func:`~repro_torch.models.paged.paged_attend_append`: ``k_slabs`` /
    ``v_slabs`` this layer's slab on each rank of ``mesh``, one whole pool
    without one; ``appends`` from ``rank_appends``); with ``cross_kv`` =
    (k, v), each (B, S_src, KVH, D), the token then attends over the
    encoder's frames (no RoPE, every frame visible).  The rest of the
    layer runs whole on x's device, but for a moe FFN, which takes the
    path ``mesh`` gives it (``moe.moe_ffn``).  The FFN sees (B, 1, d): a
    moe layer routes each sequence alone (one position shards over no
    ``model`` axis of more than one rank)."""
    B, _ = x.shape
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    q, k, v = layer.qkv(h[:, None, :])
    q = apply_rope(_heads(q, cfg.num_heads, cfg.head_dim), pos[:, None],
                   cfg.rope_theta)[:, 0]
    k = apply_rope(_heads(k, cfg.num_kv_heads, cfg.head_dim), pos[:, None],
                   cfg.rope_theta)[:, 0]
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)[:, 0]
    o = paged_attend_append(mesh, q, k, v, k_slabs, v_slabs, appends,
                            share_mask, base, seq_lens_incl, page=page)
    x = x + o.reshape(B, cfg.q_dim) @ layer.wo.to(x.dtype)
    if cross_kv is not None:
        hx = rms_norm(x, layer.ln_x, cfg.norm_eps)
        xa = layer.xattn
        qx = _heads(hx[:, None, :] @ xa.wq.to(x.dtype), cfg.num_heads,
                    cfg.head_dim)
        ox = prefill_attention(qx, *cross_kv, causal=False)
        x = x + ox.reshape(B, cfg.q_dim) @ xa.wo.to(x.dtype)
    return layer.ffn(x[:, None, :], cfg, mesh)[0][:, 0]


def _placed_qkv(layer: DecoderLayer, h: Sharded, cfg: ModelConfig):
    """The column-parallel q / k / v projections of a placed layer, the
    biases added after the product."""
    return col_parallel(h, *((getattr(layer, w), getattr(layer, b) if
                              cfg.qkv_bias else None)
                             for w, b in (("wq", "bq"), ("wk", "bk"),
                                          ("wv", "bv"))))


def _placed_ffn(layer: DecoderLayer, x: Sharded, cfg: ModelConfig,
                with_aux: bool = False):
    """x + the FFN of norm(x), laid out as x: the SwiGLU MLP, or a moe
    layer's experts where they lie (``moe.moe_ffn_placed``).  With
    ``with_aux`` (training) (x, the aux loss fp32 on the mesh's first
    rank: 0 for a dense layer)."""
    h = rms_norm_placed(x, layer.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        y = moe_ffn_placed(layer.moe, h, cfg, x.sharding, with_aux)
        y, aux = y if with_aux else (y, None)
    else:
        y = swiglu_mlp_placed(h, layer.w_gate, layer.w_up, layer.w_down,
                              x.sharding)
        aux = None
    x = blockwise(torch.add, x, y)
    if not with_aux:
        return x
    if aux is None:
        mesh = x.sharding.mesh
        with rank_scope(0):
            aux = torch.zeros((), dtype=torch.float32,
                              device=mesh.devices[0])
    return x, aux


def _rope_blocks(t: Sharded, sharding: Sharding, pos: Sharded,
                 cfg: ModelConfig) -> Sharded:
    """RoPE of a flat (B, S, heads * D) projection ``t`` laid out by
    ``sharding`` (whole heads a block), each block rotated on its owner at
    the positions ``pos`` (B, S) holds for it."""
    D = cfg.head_dim

    def one(b, sl, r):
        blk = take(t, r, sl)
        Bb, Sb = blk.shape[:2]
        return apply_rope(blk.reshape(Bb, Sb, -1, D), take(pos, r, sl[:2]),
                          cfg.rope_theta).reshape(Bb, Sb, -1)

    return map_blocks(sharding, t.shape, one)


def cross_block_placed(layer: DecoderLayer, x: Sharded, enc_out: Sharded,
                       cfg: ModelConfig, strategy: str, train: bool = False
                       ) -> Tuple[Sharded, Tuple[Sharded, Sharded]]:
    """:func:`cross_block_train` of a placed encdec layer: q column-parallel
    from the decoder's normed stream x (B, S, d), k / v column-parallel
    from the placed, normed encoder output (B, S_src, d); the attention by
    the blocks of q's layout for ``strategy``, non-causal, every frame (K3
    in prefill, :func:`~repro_torch.models.attention
    .attention_train_placed` with ``train``); ``xattn.wo`` row-parallel.
    Returns the new x (laid out as x) and the cross k, v (B, S_src, KVH *
    D), the serve state's ``cross_k`` / ``cross_v`` of this layer."""
    B, S, _ = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xa = layer.xattn
    h = rms_norm_placed(x, layer.ln_x, cfg.norm_eps)
    q, = col_parallel(h, (xa.wq, None))
    k, v = col_parallel(enc_out, (xa.wk, None), (xa.wv, None))
    qsh, _ = placed_qkv_shardings(x.sharding.mesh, strategy, B, S, H, KVH)
    if train:
        o = attention_train_placed(relayout(q, qsh), k, v, None, H, KVH, D,
                                   MaskInfo(causal=False))
    else:
        o = prefill_attention_placed(relayout(q, qsh), k, v, H, KVH, D,
                                     causal=False)
    return blockwise(torch.add, x, row_parallel(o, xa.wo, x.sharding)), \
        (k, v)


def _self_attention_placed(layer: DecoderLayer, x: Sharded, pos: Sharded,
                           cfg: ModelConfig, strategy: str, info: MaskInfo,
                           train: bool):
    """x plus the self-attention block of a placed layer (the q / k / v
    projections column-parallel, RoPE on each block of q's and k's
    layouts, the attention by q's blocks: K3, or the training attention
    with ``train``, ``wo`` row-parallel), and the post-RoPE k and v."""
    B, S, _ = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm_placed(x, layer.ln1, cfg.norm_eps)
    q, k, v = _placed_qkv(layer, h, cfg)
    qsh, ksh = placed_qkv_shardings(x.sharding.mesh, strategy, B, S, H, KVH)
    q = _rope_blocks(q, qsh, pos, cfg)
    k = _rope_blocks(k, ksh, pos, cfg)
    if train:
        o = attention_train_placed(q, k, v, pos, H, KVH, D, info)
    else:
        o = prefill_attention_placed(q, k, v, H, KVH, D, causal=info.causal,
                                     prefix_len=info.prefix_len)
    return blockwise(torch.add, x, row_parallel(o, layer.wo, x.sharding)), \
        k, v


def decoder_layer_placed(layer: DecoderLayer, x: Sharded, pos: Sharded,
                         cfg: ModelConfig, strategy: str,
                         prefix_len: int = 0, causal: bool = True,
                         enc_out: Optional[Sharded] = None
                         ) -> Tuple[Sharded, Sharded, Sharded,
                                    Optional[Tuple[Sharded, Sharded]]]:
    """A placed decoder (or encoder) layer over a full sequence (prefill):
    x (B, S, d) Sharded (by ``("batch", "act_seq_tp", None)`` for a
    decoder stack, by batch for the hybrid's shared block), pos (B, S)
    laid out as its first two dims; the attention by ``strategy``
    (``sharding.rules.attn_strategy``), causal with the ``prefix_len``
    keys visible to every query (the vlm's patches) or ``causal=False``
    (an encoder layer); with ``enc_out`` (the placed, normed encoder
    output) :func:`cross_block_placed` after the self-attention.  Returns
    the new x (laid out as x), this layer's post-RoPE k and v (B, S, KVH *
    D) Sharded, and the cross (k, v) (None without ``enc_out``)."""
    x, k, v = _self_attention_placed(layer, x, pos, cfg, strategy,
                                     MaskInfo(causal, prefix_len), False)
    xkv = None
    if enc_out is not None:
        x, xkv = cross_block_placed(layer, x, enc_out, cfg, strategy)
    return _placed_ffn(layer, x, cfg), k, v, xkv


def decoder_layer_train_placed(layer: DecoderLayer, x: Sharded, pos: Sharded,
                               cfg: ModelConfig, strategy: str,
                               info: MaskInfo,
                               enc_out: Optional[Sharded] = None
                               ) -> Tuple[Sharded, torch.Tensor]:
    """The training counterpart of :func:`decoder_layer_placed` (the
    reference's ``decoder_layer_train`` under GSPMD): the same blocks on
    the same ranks, the attention by :func:`~repro_torch.models.attention
    .attention_train_placed` (masked as ``info`` says), the cross block's
    too, a moe FFN with its aux loss.  Returns the new x (laid out as x)
    and the aux loss (fp32, on the mesh's first rank; 0 for dense)."""
    x, _, _ = _self_attention_placed(layer, x, pos, cfg, strategy, info,
                                     True)
    if enc_out is not None:
        x, _ = cross_block_placed(layer, x, enc_out, cfg, strategy,
                                  train=True)
    return _placed_ffn(layer, x, cfg, with_aux=True)


def decoder_stack_train_placed(layers, x: Sharded, pos: Sharded,
                               cfg: ModelConfig, info: MaskInfo,
                               enc_out: Optional[Sharded] = None,
                               remat: str = "minimal"
                               ) -> Tuple[Sharded, torch.Tensor]:
    """:func:`decoder_stack_train` over placed views: x (B, S, d) laid out
    by ``("batch", "act_seq_tp", None)`` (the reference's ``constrain`` at
    each layer's ends), each layer :func:`decoder_layer_train_placed`
    under the remat policy ``remat``, the attention by the strategy
    ``sharding.rules.attn_strategy`` picks.  Returns (x, the layers' aux
    losses summed on the mesh's first rank)."""
    mesh = x.sharding.mesh
    strategy = attn_strategy(cfg.num_heads, mesh)

    def body(layer, h):
        return decoder_layer_train_placed(layer, h, pos, cfg, strategy,
                                          info, enc_out)

    with rank_scope(0):
        aux = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
    for layer in layers:
        x, a = remat_call(remat, body, layer, x)
        with rank_scope(0):
            aux = aux + a
    return x, aux


def decoder_layer_decode_placed(layer: DecoderLayer, x: Sharded,
                                pos: torch.Tensor,
                                k_slabs: Sequence[torch.Tensor],
                                v_slabs: Sequence[torch.Tensor], appends,
                                share_mask: torch.Tensor,
                                base: torch.Tensor,
                                seq_lens_incl: torch.Tensor,
                                cfg: ModelConfig, page: int,
                                mesh: DeviceMesh,
                                cross_kv: Optional[Tuple[Sharded,
                                                         Sharded]] = None
                                ) -> Sharded:
    """One token per sequence through a placed decoder layer: x (B, 1, d)
    Sharded by batch, pos (B,) on the mesh's first rank.  The projections
    run column-parallel on the ranks; q, k and v meet on the first rank
    for RoPE and :func:`~repro_torch.models.paged.paged_attend_append`
    (K2 on every rank's slab, the partials LSE-combined, as for an
    unplaced model), whose output goes back through ``wo`` row-parallel.
    With ``cross_kv`` (this layer's ``cross_k`` / ``cross_v`` (B, S_src,
    KVH, D) Sharded by batch) the token then attends over its batch
    block's frames on the block's rank (K3, one query, non-causal), q
    column-parallel and ``xattn.wo`` row-parallel.  Returns the new x,
    laid out as x."""
    B = x.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm_placed(x, layer.ln1, cfg.norm_eps)
    q, k, v = (take(t, 0) for t in _placed_qkv(layer, h, cfg))
    q = apply_rope(q.reshape(B, 1, H, D), pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k.reshape(B, 1, KVH, D), pos[:, None],
                   cfg.rope_theta)[:, 0]
    o = paged_attend_append(mesh, q, k, v.reshape(B, KVH, D), k_slabs,
                            v_slabs, appends, share_mask, base,
                            seq_lens_incl, page=page)
    x = blockwise(torch.add, x, row_parallel(o.reshape(B, 1, H * D),
                                             layer.wo, x.sharding))
    if cross_kv is not None:
        xa = layer.xattn
        qx, = col_parallel(rms_norm_placed(x, layer.ln_x, cfg.norm_eps),
                           (xa.wq, None))

        def cross(b, sl, r):
            qb = take(qx, r, sl[:1])
            kb, vb = (take(t, r, sl[:1]) for t in cross_kv)
            return prefill_attention(qb.reshape(-1, 1, H, D), kb, vb,
                                     causal=False).reshape(-1, 1, H * D)

        ox = map_blocks(Sharding(mesh, (x.sharding.spec[0], None, None)),
                        (B, 1, H * D), cross)
        x = blockwise(torch.add, x, row_parallel(ox, xa.wo, x.sharding))
    return _placed_ffn(layer, x, cfg)


__all__ = ["ATTENTION_IMPLS", "CrossAttention", "DecoderLayer",
           "REMAT_POLICIES", "attn_block_train", "cross_block_placed",
           "cross_block_train",
           "decoder_layer_decode", "decoder_layer_decode_placed",
           "decoder_layer_placed", "decoder_layer_train",
           "decoder_layer_train_placed", "decoder_stack_train",
           "decoder_stack_train_placed", "remat_call"]
