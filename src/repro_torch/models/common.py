"""Shared model blocks (port of ``repro/models/common.py``): RMS norm with
a ``(1 + scale)`` gain, split-half rotary embeddings, the SwiGLU MLP and the
embedding lookup.  Plain tensor code: the JAX package computed these outside
any Pallas kernel too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, gain ``1 + scale``, result in ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Split-half rotation in fp32, result in ``x.dtype``."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU in ``x.dtype``; weights in the JAX layout ``(in, out)``."""
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    return (F.silu(g) * u) @ w_down.to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup, cast to the activation dtype."""
    return table[tokens].to(dtype)


__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu_mlp",
           "embed"]
