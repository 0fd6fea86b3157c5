"""K4 — the Mamba2 SSD intra-chunk term: the CUDA wrapper and its launch
counter.

Replaces the TPU kernel ``_ssd_intra_kernel`` of
``repro/kernels/ssd_chunk.py`` (``ssd_intra_chunk_pallas``, the
``pallas_call`` at :47).  The kernel is ``csrc/ssd_chunk.cu``; its plain
version is :func:`repro_torch.kernels.ref.ssd_intra_chunk`.

Bound on the card: bytes at the model's shapes (the inputs read once and
the fp32 output written once, over 3.35 TB/s), with the kernel body's
``2 Q^2 (N + P)`` FLOPs per chunk and head over 989 TFLOP/s below it.
bf16 inputs (what the models pass) run on the tensor cores: one CTA per
(64-row i-tile, :data:`HEADS_PER_CTA` heads, chunk row) forms ``C_i
B_j^T`` once per j-tile for its heads with ``wgmma``, and feeds each
head's decay-weighted W to ``W x_j`` as :data:`W_PARTS` bf16 parts
(three: W exact to fp32 rounding); TMA brings the tiles, x through a
tensor map over its (Bc, Q, H, P) strides.  fp32 inputs keep the first
version's FMA body.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr

#: launches of the CUDA SSD intra-chunk kernel (not of its plain version)
COUNTER = LaunchCounter("ssd_intra_chunk")

#: what the kernel is built for
HEAD_DIM = 64
MAX_STATE = 256
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: heads of a CTA of the bf16 kernel, which share its scores
HEADS_PER_CTA = 2
#: bf16 parts of W fed to the bf16 kernel's W x_j (the library has 2 and 3);
#: read at each call
W_PARTS = 3


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry, its argument types set once when the library loads."""
    fn = library("ssd_chunk").rc_ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_constants() -> dict:
    """The library's own value of :data:`HEADS_PER_CTA` (the CPU tests
    emulate the head groups with the Python copy; ``chip_smoke.py`` holds
    the two equal)."""
    return {"HEADS_PER_CTA": library("ssd_chunk").rc_ssd_heads_per_cta()}


def ssd_intra_chunk_cuda(xb, dtb, cum, Bb, Cb):
    """Launch the kernel once; xb (B,Q,H,P) and Bb / Cb (B,Q,N) of one
    dtype (bf16 or fp32), dtb / cum (B,Q,H) fp32, all contiguous on the
    card; returns (B,Q,H,P) fp32.  Raises on inputs it does not take."""
    B, Q, H, P = xb.shape
    N = Bb.shape[-1]
    if P != HEAD_DIM or not 0 < N <= MAX_STATE or not 0 < Q <= MAX_CHUNK:
        raise ValueError(f"SSD intra-chunk kernel: x {tuple(xb.shape)}, "
                         f"state {N} (needs P = {HEAD_DIM}, N <= "
                         f"{MAX_STATE}, Q <= {MAX_CHUNK})")
    if tuple(dtb.shape) != (B, Q, H) or tuple(cum.shape) != (B, Q, H) \
            or tuple(Bb.shape) != (B, Q, N) or tuple(Cb.shape) != (B, Q, N):
        raise ValueError("SSD intra-chunk kernel: shapes disagree")
    if xb.dtype not in _DTYPES:
        raise ValueError(f"SSD intra-chunk kernel: x dtype {xb.dtype}")
    for name, t, dt in (("x", xb, xb.dtype), ("dt", dtb, torch.float32),
                        ("cum", cum, torch.float32), ("B", Bb, xb.dtype),
                        ("C", Cb, xb.dtype)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"SSD intra-chunk kernel: {name} must be a "
                             f"contiguous CUDA {dt} tensor")
    if xb.dtype == torch.bfloat16 and (
            N % 8 or any(t.data_ptr() % 16 for t in (xb, Bb, Cb))):
        raise ValueError(f"SSD intra-chunk kernel: bf16 tiles come through "
                         f"tensor maps, which need N % 8 == 0 (N = {N}) and "
                         f"16-byte aligned x / B / C")
    y = torch.empty((B, Q, H, P), dtype=torch.float32, device=xb.device)
    check(_entry()(xb.data_ptr(), dtb.data_ptr(), cum.data_ptr(),
                   Bb.data_ptr(), Cb.data_ptr(), y.data_ptr(), B, Q, H, N,
                   _DTYPES[xb.dtype], W_PARTS, stream_ptr(xb.device)),
          "SSD intra-chunk kernel")
    COUNTER.n += 1
    return y


__all__ = ["COUNTER", "kernel_constants", "ssd_intra_chunk_cuda"]
