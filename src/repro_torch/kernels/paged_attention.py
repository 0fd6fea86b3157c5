"""K2 — paged decode attention: the CUDA wrapper and its launch counter.

Replaces the TPU kernel ``_paged_attn_kernel`` of
``repro/kernels/paged_attention.py`` (``paged_attention_slab_pallas``, the
``pallas_call`` at :98).  The kernel is ``csrc/paged_attention.cu``; its
plain version is :func:`repro_torch.kernels.ref.paged_attention_slab`.

q, K and V are bf16 (the published configs, at :data:`HEAD_DIMS`) or fp32
(the reduced configs' head dim 32, and the others, at
:data:`F32_HEAD_DIMS`), as the Pallas kernel takes either; the outputs are
fp32 whatever the input type.

Bound on the card: bytes (the K/V slots below some reader's length read
once, over 3.35 TB/s).
The :data:`SPLITS` CTAs of a thread-block cluster split each (kv head,
sequence)'s visible blocks into contiguous ranges (split ``s`` of ``n``
visible blocks takes positions ``[s n // SPLITS, (s + 1) n // SPLITS)``),
stream their pages through shared memory with ``cp.async``, and rank 0
merges the partial softmax sums through distributed shared memory: one
launch per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr

#: launches of the CUDA decode-attention kernel (not of its plain version)
COUNTER = LaunchCounter("paged_attention")

#: bf16 head dims the kernel is built for (seamless-m4t-medium's decoder 64,
#: zamba2's shared block 80, llama3.2-3b 128, paligemma-3b 256: a CTA of 256
#: threads there)
HEAD_DIMS = (64, 80, 128, 256)
#: fp32 head dims: every reduced config's 32, and the bf16 ones
F32_HEAD_DIMS = (32, 64, 80, 128, 256)
#: the head dims of each input dtype, and its code in the C entry
_DTYPES = {torch.bfloat16: (1, HEAD_DIMS),
           torch.float32: (0, F32_HEAD_DIMS)}
MAX_GROUP = 8
MAX_PAGE = 64
#: CTAs of a cluster, each taking one contiguous range of visible blocks
SPLITS = 8
SMEM_LIMIT = 227 * 1024


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry, its argument types set once when the library loads."""
    fn = library("paged_attention").rc_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _smem_bytes(head_dim: int, nblk: int, dtype) -> int:
    """Shared memory one CTA of the ``dtype`` instance takes for a slab of
    ``nblk`` blocks (-1: no such instance)."""
    fn = library("paged_attention").rc_paged_attention_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(head_dim, nblk, _DTYPES[dtype][0]))


def kernel_constants() -> dict:
    """The library's own values of :data:`SPLITS`, :data:`MAX_PAGE` and
    :data:`MAX_GROUP` (the CPU tests emulate the split with the Python
    copies; ``chip_smoke.py`` holds the two equal)."""
    lib = library("paged_attention")
    return {"SPLITS": lib.rc_paged_attention_splits(),
            "MAX_PAGE": lib.rc_paged_attention_max_page(),
            "MAX_GROUP": lib.rc_paged_attention_max_group()}


def paged_attention_slab_cuda(q, k_slab, v_slab, share_mask, base, seq_lens,
                              *, page: int):
    """Launch the kernel once; q / k / v bf16 or fp32, one dtype; returns
    (acc (B,H,D), l (B,H), m (B,H)) fp32.  Raises on inputs the kernel does
    not take."""
    nblk, pg, KVH, D = k_slab.shape
    B, H, Dq = q.shape
    code, dims = _DTYPES.get(q.dtype, (None, ()))
    if code is None:
        raise ValueError(f"paged attention kernel: q / K / V dtype {q.dtype} "
                         "(needs bf16 or fp32)")
    if pg != page or page > MAX_PAGE or Dq != D or D not in dims:
        raise ValueError(f"paged attention kernel: page {pg} vs {page} "
                         f"(<= {MAX_PAGE}), head dim {D} (needs one of "
                         f"{dims} at {q.dtype})")
    if H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"paged attention kernel: {H} heads over {KVH} kv "
                         f"heads (group <= {MAX_GROUP})")
    for name, t, dt in (("q", q, q.dtype), ("k", k_slab, q.dtype),
                        ("v", v_slab, q.dtype),
                        ("share_mask", share_mask, torch.int8),
                        ("base", base, torch.int32),
                        ("seq_lens", seq_lens, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be a "
                             f"contiguous CUDA {dt} tensor")
    if k_slab.data_ptr() % 16 or v_slab.data_ptr() % 16:
        raise ValueError("paged attention kernel: K/V slabs must be 16-byte "
                         "aligned (the pages are copied 16 bytes at a time)")
    if tuple(share_mask.shape) != (nblk, B) or base.shape[0] != nblk \
            or seq_lens.shape[0] != B:
        raise ValueError("paged attention kernel: table shapes disagree")
    if _smem_bytes(D, nblk, q.dtype) > SMEM_LIMIT:
        raise ValueError("paged attention kernel: slab too large for one "
                         "CTA's block list")
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    check(_entry()(q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
                   share_mask.data_ptr(), base.data_ptr(),
                   seq_lens.data_ptr(), acc.data_ptr(), l.data_ptr(),
                   m.data_ptr(), nblk, page, KVH, B, H // KVH, D, code,
                   D ** -0.5, stream_ptr(q.device)),
          "paged attention kernel")
    COUNTER.n += 1
    return acc, l, m


__all__ = ["COUNTER", "SPLITS", "kernel_constants",
           "paged_attention_slab_cuda"]
