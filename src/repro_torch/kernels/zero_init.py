"""K6 — BuZ bulk zero-init: the CUDA wrapper.

Replaces the TPU kernel ``_zero_init_kernel`` of
``repro/kernels/zero_init.py`` (``zero_init_pallas``, the ``pallas_call``
at :46), which DMA-broadcast the reserved zero block into every listed
block.  The kernel is ``csrc/zero_init.cu`` over the shared body
``csrc/block_move.cuh``; its plain version is
:func:`repro_torch.kernels.ref.zero_init`.

Bound on the card: bytes, writes only.  The kernel stores zero bytes and
never reads the zero block (all zeros by construction), which halves the
traffic of the broadcast and gives the same pool: each CTA zeroes one
shared tile and issues bulk stores from it.  Zero rows only write, so one
call is a single wave.  The wrapper makes ONE C call, which drops the
padding and launches with the ids as launch parameters
(:func:`repro_torch.kernels.fpm_copy.block_move`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.fpm_copy import block_move

#: launches of the zero-init kernel (K6)
COUNTER = LaunchCounter("zero_init")


def zero_init_cuda(pool: torch.Tensor, ids, *, block_axis: int
                   ) -> torch.Tensor:
    """Zero the listed blocks on the card, in place, with ONE launch of K6
    (none when every id is padding)."""
    if block_move("rc_zero_init", pool, pool, ids, block_axis=block_axis):
        COUNTER.n += 1
    return pool


__all__ = ["COUNTER", "zero_init_cuda"]
