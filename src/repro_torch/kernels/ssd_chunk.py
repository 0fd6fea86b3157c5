"""K4 — the Mamba2 SSD intra-chunk term: the CUDA wrapper and its launch
counter.

Replaces the TPU kernel ``_ssd_intra_kernel`` of
``repro/kernels/ssd_chunk.py`` (``ssd_intra_chunk_pallas``, the
``pallas_call`` at :47).  The kernel is ``csrc/ssd_chunk.cu``; its plain
version is :func:`repro_torch.kernels.ref.ssd_intra_chunk`.

Bound on the card: bytes at the model's shapes (the inputs read once and
the fp32 output written once, over 3.35 TB/s), with the kernel body's
``2 Q^2 (N + P)`` FLOPs per chunk and head over 989 TFLOP/s close behind.
The first version is fp32 FMA on shared-memory tiles, one CTA per (64-row
i-tile, head, chunk row), walking the j-tiles only up to the diagonal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LaunchCounter, check, library, stream_ptr

#: launches of the CUDA SSD intra-chunk kernel (not of its plain version)
COUNTER = LaunchCounter("ssd_intra_chunk")

#: what the kernel is built for
HEAD_DIM = 64
MAX_STATE = 256
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    y = torch.empty((B, Q, H, P), dtype=torch.float32, device=xb.device)
    fn = library("ssd_chunk").rc_ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(xb.data_ptr(), dtb.data_ptr(), cum.data_ptr(), Bb.data_ptr(),
             Cb.data_ptr(), y.data_ptr(), B, Q, H, N, _DTYPES[xb.dtype],
             stream_ptr(xb.device)),
          "SSD intra-chunk kernel")
    COUNTER.n += 1
    return y


__all__ = ["COUNTER", "ssd_intra_chunk_cuda"]
