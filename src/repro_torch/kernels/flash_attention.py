"""K3 — prefill attention: the CUDA wrapper and its launch counter.

Replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (``flash_attention_pallas``, the
``pallas_call`` at :93).  The kernel is ``csrc/flash_attention.cu``; its
plain version is :func:`repro_torch.kernels.ref.flash_attention`.

q ``(B, H, Sq, D)`` against k / v ``(B, KVH, Skv, D)``: a decoder's causal
prefill (Sq = Skv), a block of its query rows over the keys up to the
block's last row (``q_offset``, the block's first position: a placed
model's ``"seq"`` attention), an encoder's non-causal self-attention, and
an encoder-decoder's cross-attention (text queries over the source
frames, Sq != Skv, one query at a decode step).

Bound on the card: the larger of the FLOPs of the visible (query, key)
pairs over 989 TFLOP/s and the bytes over 3.35 TB/s.  The kernel runs both
products on the tensor cores (``wgmma``) and loads its tiles with TMA
through tensor maps built from the inputs' strides, so q / k / v may be
strided views (the model passes the ``(B, S, H, D)`` activations
transposed, without a copy).  The output is written in ``(B, Sq, H, D)``
memory order and returned as its ``(B, H, Sq, D)`` view, so the caller's
transpose back is contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr

#: launches of the CUDA prefill-attention kernel (not of its plain version)
COUNTER = LaunchCounter("flash_attention")

#: head dims the kernel is built for (seamless-m4t-medium 64, zamba2's
#: shared block 80, llama3.2-3b 128, paligemma-3b 256: its head dim split
#: over two warpgroups)
HEAD_DIMS = (64, 80, 128, 256)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry, its argument types set once when the library loads."""
    fn = library("flash_attention").rc_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tma_strides(name: str, t: torch.Tensor) -> tuple:
    """The (b, h, s) strides of a (B, heads, S, D) bf16 operand, in
    elements, as its tensor map takes them; raises ``ValueError`` unless
    the last dimension is contiguous, the other strides are positive
    multiples of 16 bytes and the data is 16-byte aligned.  A dimension of
    size 1 is never stepped, so its stride is replaced by a valid one."""
    sb, sh, ss, sd = t.stride()
    nb, nh, ns, d = t.shape
    out = (sb if nb > 1 else d, sh if nh > 1 else d, ss if ns > 1 else d)
    if sd != 1 or t.data_ptr() % 16 or min(out) <= 0 or \
            (out[0] | out[1] | out[2]) % 8:
        raise ValueError(f"flash attention kernel: {name} {tuple(t.shape)} "
                         f"with strides {t.stride()} (elements) needs a "
                         "contiguous last dimension, other strides positive "
                         "multiples of 16 bytes and 16-byte aligned data")
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         prefix_len: int = 0, q_offset: int = 0):
    """Launch the kernel once; q (B,H,Sq,D), k/v (B,KVH,Skv,D) bf16 on the
    card, any strides :func:`tma_strides` takes; returns (B,H,Sq,D) bf16, a
    view of a (B,Sq,H,D) buffer.  ``q_offset`` (>= 0): the position of q's
    first row among the keys, which moves the causal edge.  Raises on
    inputs it does not take."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or H % KVH or k.shape != (B, KVH, Skv, D) \
            or v.shape != k.shape or (Sq and not Skv) or q_offset < 0:
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(head dim must be one of {HEAD_DIMS})")
    if not q.is_cuda or not (q.dtype == k.dtype == v.dtype == torch.bfloat16
                             and q.device == k.device == v.device):
        raise ValueError("flash attention kernel: q, k, v must be bf16 "
                         "tensors on one CUDA device")
    strides = tma_strides("q", q) + tma_strides("k", k) + \
        tma_strides("v", v) + (Sq * H * D, D, H * D)
    out = torch.empty((B, Sq, H, D), dtype=torch.bfloat16, device=q.device)
    if Sq:
        check(_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), (ctypes.c_longlong * 12)(*strides),
                       B, H, KVH, Sq, Skv, D, int(bool(causal)),
                       int(prefix_len), int(q_offset), D ** -0.5,
                       stream_ptr(q.device)),
              "flash attention kernel")
        COUNTER.n += 1
    return out.transpose(1, 2)


__all__ = ["COUNTER", "HEAD_DIMS", "flash_attention_cuda", "tma_strides"]
