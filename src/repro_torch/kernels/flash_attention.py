"""K3 — prefill attention: the CUDA wrapper and its launch counter.

Replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (``flash_attention_pallas``, the
``pallas_call`` at :93).  The kernel is ``csrc/flash_attention.cu``; its
plain version is :func:`repro_torch.kernels.ref.flash_attention`.

Bound on the card: the larger of the causal FLOPs over 989 TFLOP/s and the
bytes over 3.35 TB/s.  The first version is fp32 FMA on shared-memory tiles,
one CTA per (64-row q tile, head, batch), walking kv tiles only up to the
causal edge and masking a ragged sequence length.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr

#: launches of the CUDA prefill-attention kernel (not of its plain version)
COUNTER = LaunchCounter("flash_attention")

#: head dims the kernel is built for (llama3.2-3b 128, zamba2's shared
#: block 80)
HEAD_DIMS = (80, 128)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         prefix_len: int = 0):
    """Launch the kernel once; q (B,H,S,D), k/v (B,KVH,S,D) bf16 on the
    card; returns (B,H,S,D) bf16.  Raises on inputs it does not take."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if D not in HEAD_DIMS or H % KVH or tuple(k.shape) != (B, KVH, S, D) \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(head dim must be one of {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be a "
                             "contiguous CUDA bf16 tensor")
    out = torch.empty_like(q)
    fn = library("flash_attention").rc_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             KVH, S, D, int(bool(causal)), int(prefix_len), float(D ** -0.5),
             stream_ptr(q.device)),
          "flash attention kernel")
    COUNTER.n += 1
    return out


__all__ = ["COUNTER", "flash_attention_cuda"]
