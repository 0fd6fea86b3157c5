"""Shared model blocks (port of ``repro/models/common.py``): RMS norm with
a ``(1 + scale)`` gain, split-half rotary embeddings, the SwiGLU MLP, the
embedding lookup and the sequence-chunked training cross-entropy.  Plain
tensor code: the JAX package computed these outside any Pallas kernel too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def checkpointed(fn, *args, **kwargs):
    """``fn(*args)`` under ``torch.utils.checkpoint``: backward recomputes
    its activations instead of keeping them (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``; ``context_fn`` narrows
    it, ``models/transformer.py REMAT_POLICIES``).  The training forward
    draws no random numbers, so no RNG state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def chunked_softmax_xent(x_final: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy over the masked positions plus ``z_loss`` times
    the mean squared log-partition, over sequence chunks so that the full
    fp32 logits never exist at once.  x_final (B, S, D); w_out (D, V);
    labels / mask (B, S).  S is padded up to a multiple of the chunk count
    (``max(S // chunk, 1)``; the padding is masked); each chunk's logits
    are a bf16 x bf16 product read as fp32, and backward recomputes them
    (the reference's checkpointed scan body)."""
    B, S, D = x_final.shape
    n_chunks = max(S // chunk, 1)
    if S % n_chunks:
        pad = n_chunks - S % n_chunks
        x_final = F.pad(x_final, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    chunk = S // n_chunks
    labels = labels.long()
    mask = mask.float()

    def body(xb, lb, mb):
        logits = (xb.to(torch.bfloat16) @ w_out.to(torch.bfloat16)).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
        return ((lse - gold) * mb).sum(), (lse.square() * mb).sum()

    loss_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                   device=x_final.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ce, zl = checkpointed(body, x_final[:, sl], labels[:, sl],
                              mask[:, sl])
        loss_sum = loss_sum + ce
        z_sum = z_sum + zl
    denom = mask.sum().clamp_min(1.0)
    return loss_sum / denom + z_loss * z_sum / denom


__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu_mlp",
           "embed", "checkpointed", "chunked_softmax_xent"]
