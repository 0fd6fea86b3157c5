"""Prefill attention of the dense model (port of the prefill half of
``repro/models/attention.py``): the model's ``(B, S, H, D)`` layout
transposed to K3's ``(B, H, S, D)`` (kernels/flash_attention.py), causal
plus the prefix-LM exception.  Decode attention is K2, called from
models/paged.py."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      prefix_len: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KVH, D) -> (B, S, H, D) in q.dtype."""
    out = kops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               causal=causal, prefix_len=prefix_len)
    return out.transpose(1, 2)


__all__ = ["prefill_attention"]
