"""The dense language model (port of ``repro/models/lm.py``, the dense
family): prefill over a prompt and one decode step over the paged pools."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig, RowCloneConfig
from repro_torch.models.common import embed, rms_norm
from repro_torch.models.transformer import (DecoderLayer, decoder_layer_decode,
                                            decoder_layer_train)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class LanguageModel(nn.Module):
    """Weights of the dense decoder: embedding (tied to the head when
    ``cfg.tie_embeddings``), final norm and the layers.  Build one with
    :func:`repro_torch.weights.init_params` or
    :func:`repro_torch.weights.from_jax_params`."""

    def __init__(self, cfg: ModelConfig, device,
                 rc: RowCloneConfig = RowCloneConfig()):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.page = rc.page_size
        dt = model_dtype(cfg)
        self.embed = nn.Parameter(
            torch.zeros((cfg.padded_vocab, cfg.d_model), dtype=dt,
                        device=device), requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.padded_vocab), dtype=dt,
                            device=device), requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dt, device)
                                    for _ in range(cfg.num_layers))

    @property
    def act_dtype(self) -> torch.dtype:
        return model_dtype(self.cfg)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head is a bf16 product whatever the config dtype (as
        ``lm.py:94-98`` of the reference); logits come back fp32."""
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (last-position logits (B, V) fp32, k, v), k / v
        (L, B, S, KVH, D) post-RoPE."""
        cfg = self.cfg
        B, S = tokens.shape
        x = embed(self.embed, tokens, self.act_dtype)
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        ks, vs = [], []
        for layer in self.layers:
            x, (k, v) = decoder_layer_train(layer, x, pos, cfg)
            ks.append(k)
            vs.append(v)
        xn = rms_norm(x[:, -1, :], self.final_norm, cfg.norm_eps)
        return self._logits(xn), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                    k_pools: torch.Tensor, v_pools: torch.Tensor,
                    block_table: torch.Tensor, share_mask: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
        """tokens (B,) just sampled, seq_lens (B,) the position of each
        (tokens already in the cache).  Appends every layer's K/V into
        ``k_pools`` / ``v_pools`` (L, nblk, page, KVH, D) IN PLACE and
        returns the next-position logits (B, V) fp32."""
        cfg, page = self.cfg, self.page
        pos = seq_lens.long()
        x = embed(self.embed, tokens, self.act_dtype)
        ids = torch.gather(block_table.long(), 1,
                           (pos // page)[:, None])[:, 0]
        # batch slots with a sequence (an empty slot's table row is -1)
        rows = (ids >= 0).nonzero()[:, 0]
        ids, offsets = ids[rows], (pos % page)[rows]
        seq_incl = (pos + 1).to(torch.int32)
        for li, layer in enumerate(self.layers):
            x = decoder_layer_decode(layer, x, pos, k_pools[li], v_pools[li],
                                     rows, ids, offsets, share_mask, base,
                                     seq_incl, cfg, page)
        xn = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(xn)


def kv_to_pools(kv: torch.Tensor, page: int, dtype: torch.dtype,
                nper: int) -> torch.Tensor:
    """(L, B, S, KVH, D) -> (L, B * nper, page, KVH, D): the contiguous
    layout with ``nper`` blocks per sequence, zero-padded past S (the
    paged attention's validity check masks the padding)."""
    L, B, S, KVH, D = kv.shape
    cap = nper * page
    if S < cap:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, cap - S))
    return kv.reshape(L, B * nper, page, KVH, D).to(dtype)


__all__ = ["LanguageModel", "kv_to_pools", "model_dtype"]
