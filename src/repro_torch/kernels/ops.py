"""Public entries of the port's kernels — the one resolution rule.

Every op runs its CUDA kernel for tensors on the card and its plain PyTorch
version (kernels/ref.py) for tensors on the CPU.  An explicit override
always wins: ``use_kernel=False`` on a call, or :func:`plain_versions` around
a whole code path, runs the plain version on the card (``chip_smoke.py``
compares the two that way).  ``use_kernel=True`` on a CPU tensor raises.
There is no fallback: on a CUDA tensor a kernel that does not build or
does not launch raises.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_dispatch import (COUNTER as FUSED_COUNTER,
                                                fused_dispatch_cuda,
                                                notify_launch)
from repro_torch.kernels.flash_attention import (COUNTER as FLASH_COUNTER,
                                                 flash_attention_cuda)
from repro_torch.kernels.paged_attention import (COUNTER as PAGED_COUNTER,
                                                 paged_attention_slab_cuda)

#: every kernel's launch counter, by kernel name
KERNEL_COUNTERS = {c.name: c for c in (FUSED_COUNTER, PAGED_COUNTER,
                                       FLASH_COUNTER)}

_override: Optional[bool] = None


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run every op inside the block through its plain version, on any
    device (the explicit override)."""
    global _override
    prev, _override = _override, False
    try:
        yield
    finally:
        _override = prev


def use_kernel_for(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """The resolution rule: an explicit argument, else the active
    :func:`plain_versions` override, else "kernel iff on the card"."""
    if use_kernel is None:
        use_kernel = _override
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError("a CUDA kernel was requested for a CPU tensor")
    return bool(use_kernel)


def fused_dispatch(pools: Sequence[torch.Tensor],
                   zero_blocks: Sequence[torch.Tensor], cmds, *,
                   block_axis: int = 0, primary=None,
                   use_kernel: Optional[bool] = None):
    """Drain one flushed ``(m, 3)`` command table over every pool, IN
    PLACE, as one dispatch (see kernels/fused_dispatch.py).  Returns the
    pools."""
    if use_kernel_for(pools[0], use_kernel):
        out = fused_dispatch_cuda(pools, cmds, block_axis=block_axis,
                                  primary=primary)
    else:
        out = ref.fused_dispatch(pools, zero_blocks, cmds,
                                 block_axis=block_axis, primary=primary)
    notify_launch(len(cmds), len(pools), "fused")
    return out


def paged_attention_slab(q, k_slab, v_slab, share_mask, base, seq_lens, *,
                         page: int, use_kernel: Optional[bool] = None):
    """Decode attention over one pool slab: (acc, l, m), fp32."""
    if use_kernel_for(q, use_kernel):
        return paged_attention_slab_cuda(q, k_slab, v_slab, share_mask, base,
                                         seq_lens, page=page)
    return ref.paged_attention_slab(q, k_slab, v_slab, share_mask, base,
                                    seq_lens, page=page)


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0,
                    use_kernel: Optional[bool] = None):
    """Prefill attention; q (B,H,S,D), k/v (B,KVH,S,D)."""
    if use_kernel_for(q, use_kernel):
        return flash_attention_cuda(q, k, v, causal=causal,
                                    prefix_len=prefix_len)
    return ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)


__all__ = ["KERNEL_COUNTERS", "plain_versions", "use_kernel_for",
           "fused_dispatch", "paged_attention_slab", "flash_attention"]
