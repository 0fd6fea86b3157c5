"""Dense decoder layer (port of ``repro/models/transformer.py``, the dense
family): GQA attention block + SwiGLU MLP, for prefill and for one decode
step over the paged pools.  Weights keep the JAX layout ``(in, out)``, so
``h @ w`` reads the same in both packages."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.attention import prefill_attention
from repro_torch.models.common import apply_rope, rms_norm, swiglu_mlp
from repro_torch.models.paged import attend_append_local


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One dense decoder layer's weights.  Norm gains stay fp32; the
    projections are in the model dtype."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param((d,), torch.float32, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.wq = _param((d, cfg.q_dim), dtype, device)
        self.wk = _param((d, cfg.kv_dim), dtype, device)
        self.wv = _param((d, cfg.kv_dim), dtype, device)
        self.wo = _param((cfg.q_dim, d), dtype, device)
        self.w_gate = _param((d, cfg.d_ff), dtype, device)
        self.w_up = _param((d, cfg.d_ff), dtype, device)
        self.w_down = _param((cfg.d_ff, d), dtype, device)

    def qkv(self, h: torch.Tensor):
        dt = h.dtype
        return h @ self.wq.to(dt), h @ self.wk.to(dt), h @ self.wv.to(dt)

    def ffn(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + swiglu_mlp(h, self.w_gate, self.w_up, self.w_down)


def _heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, d))


def decoder_layer_train(layer: DecoderLayer, x: torch.Tensor,
                        pos: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """Full-sequence layer for prefill: x (B, S, d), pos (B, S).  Returns
    the new x and this layer's post-RoPE (k, v), each (B, S, KVH, D)."""
    B, S, _ = x.shape
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    q, k, v = layer.qkv(h)
    q = apply_rope(_heads(q, cfg.num_heads, cfg.head_dim), pos,
                   cfg.rope_theta)
    k = apply_rope(_heads(k, cfg.num_kv_heads, cfg.head_dim), pos,
                   cfg.rope_theta)
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)
    o = prefill_attention(q, k, v, causal=True)
    x = x + o.reshape(B, S, cfg.q_dim) @ layer.wo.to(x.dtype)
    return layer.ffn(x, cfg), (k, v)


def decoder_layer_decode(layer: DecoderLayer, x: torch.Tensor,
                         pos: torch.Tensor, k_slab: torch.Tensor,
                         v_slab: torch.Tensor, rows: torch.Tensor,
                         blk_ids: torch.Tensor, offsets: torch.Tensor,
                         share_mask: torch.Tensor,
                         base: torch.Tensor, seq_lens_incl: torch.Tensor,
                         cfg: ModelConfig, page: int) -> torch.Tensor:
    """One token per sequence: x (B, d), pos (B,).  Appends this layer's
    new K/V into ``k_slab`` / ``v_slab`` IN PLACE and attends over them."""
    B, _ = x.shape
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    q, k, v = layer.qkv(h[:, None, :])
    q = apply_rope(_heads(q, cfg.num_heads, cfg.head_dim), pos[:, None],
                   cfg.rope_theta)[:, 0]
    k = apply_rope(_heads(k, cfg.num_kv_heads, cfg.head_dim), pos[:, None],
                   cfg.rope_theta)[:, 0]
    v = _heads(v, cfg.num_kv_heads, cfg.head_dim)[:, 0]
    o = attend_append_local(q, k, v, k_slab, v_slab, rows, blk_ids, offsets,
                            share_mask, base, seq_lens_incl, page=page)
    x = x + o.reshape(B, cfg.q_dim) @ layer.wo.to(x.dtype)
    return layer.ffn(x, cfg)


__all__ = ["DecoderLayer", "decoder_layer_train", "decoder_layer_decode"]
