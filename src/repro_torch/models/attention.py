"""Prefill attention of the port's models (port of the prefill half of
``repro/models/attention.py``): the model's ``(B, S, H, D)`` layout
handed to K3 as ``(B, H, S, D)`` views, without a copy
(kernels/flash_attention.py reads any 16-byte-aligned strides): a
decoder's causal self-attention plus the prefix-LM exception, an
encoder's non-causal self-attention, and an encoder-decoder's
cross-attention over the encoder's frames.  Decode attention is K2, called
from models/paged.py."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      prefix_len: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in
    q.dtype.  The kernel writes its output in (B, Sq, H, D) order, so the
    result is contiguous for the o-projection."""
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               prefix_len=prefix_len)
    return out.transpose(1, 2)


__all__ = ["prefill_attention"]
