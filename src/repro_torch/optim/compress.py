"""Error-feedback gradient compression for the DP all-reduce (port of
``repro/optim/compress.py``) at one data-parallel rank.

* bf16: the gradient crosses as bfloat16; the fp32 residual stays and is
  added back next step, so the compression is unbiased over time.
* int8: a per-tensor scale (the max |g| over the DP ranks / 127), int8 on
  the wire, fp32 accumulation.

With no DP axis the all-reduce is the identity (the reference's
``tests/test_substrates.py`` calls them so): the error-feedback algebra
runs, nothing is reduced.  A call that names DP axes raises: the real
all-reduce comes with the mesh (ROADMAP item 12b).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _one_rank(dp_axes: Sequence[str], dp_size: int) -> None:
    if tuple(dp_axes) or dp_size != 1:
        raise NotImplementedError(
            f"compressed all-reduce over {tuple(dp_axes)} ({dp_size} ranks) "
            "needs the mesh (ROADMAP item 12b)")


def _map(fn, grads, err):
    if isinstance(grads, dict):
        out = {k: fn(grads[k], err[k]) for k in grads}
        return ({k: o[0] for k, o in out.items()},
                {k: o[1] for k, o in out.items()})
    out = [fn(g, e) for g, e in zip(grads, err)]
    return type(grads)(o[0] for o in out), type(grads)(o[1] for o in out)


def compress_psum_bf16(grads, err, dp_axes: Tuple[str, ...], dp_size: int):
    """grads / err: a dict or a sequence of tensors (the rank's partial
    grads and the feedback residual).  Returns (mean grads fp32, new
    residual)."""
    _one_rank(dp_axes, dp_size)

    def one(g, e):
        g32 = g.float() + e
        gc = g32.to(torch.bfloat16)
        return gc.float() / dp_size, g32 - gc.float()

    return _map(one, grads, err)


def compress_psum_int8(grads, err, dp_axes: Tuple[str, ...], dp_size: int):
    """int8 wire format with a per-tensor scale."""
    _one_rank(dp_axes, dp_size)

    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_e = g32 - q.float() * scale
        return q.to(torch.int32).float() * scale / dp_size, new_e

    return _map(one, grads, err)


def init_error_state(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, dict):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    return type(params)(torch.zeros_like(p, dtype=torch.float32)
                        for p in params)


__all__ = ["compress_psum_bf16", "compress_psum_int8", "init_error_state"]
