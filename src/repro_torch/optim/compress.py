"""Error-feedback gradient compression for the DP all-reduce (port of
``repro/optim/compress.py``).

* bf16: the gradient crosses as bfloat16; the fp32 residual stays and is
  added back next step, so the compression is unbiased over time.
* int8: a per-tensor scale (the max |g| over the DP ranks / 127), int8 on
  the wire, fp32 accumulation.

The reference runs these inside a ``shard_map`` whose manual axes are the
DP axes, each device with its own partial grads and residual.  The port
takes that per-rank dataflow explicitly: with a ``mesh``, ``grads`` and
``err`` are lists of one tree per rank (dicts or sequences of tensors,
each rank's on its device), and each group of ranks that share their
coordinates on the axes outside ``dp_axes`` reduces together (the
reference's ``psum`` / ``pmax`` over ``dp_axes``).  Without a mesh the
call is one rank's, and ``dp_axes`` must be ``()``: the error-feedback
algebra runs and nothing is reduced (the reference's
``tests/test_substrates.py`` calls them so).

The reference's train step reads no ``TrainConfig.grad_compress`` and
calls neither function; nor does the port's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh


def dp_groups(mesh: DeviceMesh, dp_axes: Sequence[str]) -> List[List[int]]:
    """The ranks of ``mesh`` grouped by their coordinates on the axes not
    in ``dp_axes`` (each group in rank order): the ranks one DP
    all-reduce spans."""
    groups: Dict[tuple, List[int]] = {}
    for r in range(mesh.size):
        key = tuple(c for a, c in mesh.coords(r).items() if a not in dp_axes)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def _all_reduce(group_fn: Callable, grads, err, dp_axes: Tuple[str, ...],
                dp_size: int, mesh):
    """``group_fn(gs, es, dp_size) -> (means, new_es)`` over each leaf of
    each DP group; returns (the ranks' mean grads, their residuals), or
    one rank's without a mesh."""
    if mesh is None:
        if tuple(dp_axes) or dp_size != 1:
            raise ValueError(f"an all-reduce over {tuple(dp_axes)} "
                             f"({dp_size} ranks) takes mesh= and one tree "
                             "per rank")
        grads, err, groups = [grads], [err], [[0]]
    else:
        groups = dp_groups(mesh, dp_axes)
    keys = list(grads[0]) if isinstance(grads[0], dict) \
        else range(len(grads[0]))
    out_g = [dict() for _ in grads]
    out_e = [dict() for _ in grads]
    for k in keys:
        for grp in groups:
            means, new_es = group_fn([grads[r][k] for r in grp],
                                     [err[r][k] for r in grp], dp_size)
            for r, m, e in zip(grp, means, new_es):
                out_g[r][k], out_e[r][k] = m, e

    def like(tree, vals):
        return vals if isinstance(tree, dict) \
            else type(tree)(vals[i] for i in keys)
    out = ([like(t, o) for t, o in zip(grads, out_g)],
           [like(t, o) for t, o in zip(err, out_e)])
    return out if mesh is not None else (out[0][0], out[1][0])


def _bf16_group(gs, es, dp_size: int):
    g32 = [g.float() + e for g, e in zip(gs, es)]
    gc = [x.to(torch.bfloat16) for x in g32]
    s = gc[0].float()
    for x in gc[1:]:                 # fp32 adds in rank order, one rounding
        s = s + x.to(s.device).float()
    mean = s.to(torch.bfloat16).float() / dp_size
    return ([mean.to(g.device) for g in gs],
            [a - c.float() for a, c in zip(g32, gc)])


def _int8_group(gs, es, dp_size: int):
    g32 = [g.float() + e for g, e in zip(gs, es)]
    dev = g32[0].device
    amax = torch.stack([x.abs().max().to(dev) for x in g32]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    qs, new_es = [], []
    for x in g32:
        sc = scale.to(x.device)
        q = torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8)
        qs.append(q)
        new_es.append(x - q.float() * sc)
    s = qs[0].to(torch.int32)
    for q in qs[1:]:                 # exact: int32 sums
        s = s + q.to(dev, torch.int32)
    mean = s.float() * scale / dp_size
    return [mean.to(g.device) for g in gs], new_es


def compress_psum_bf16(grads, err, dp_axes: Tuple[str, ...], dp_size: int,
                       mesh=None):
    """grads / err: one rank's tree (no mesh), or a list of one tree per
    rank of ``mesh`` (partial grads and feedback residual).  Returns (the
    mean grads fp32, the new residual), in the same form: the bf16 grads
    of each DP group summed in fp32 and rounded to bf16 once (as XLA's
    all-reduce of bf16 sums), divided by ``dp_size``."""
    return _all_reduce(_bf16_group, grads, err, dp_axes, dp_size, mesh)


def compress_psum_int8(grads, err, dp_axes: Tuple[str, ...], dp_size: int,
                       mesh=None):
    """int8 wire format with a per-tensor scale from the max |g| over each
    DP group (one scalar ``pmax``); int32 sums."""
    return _all_reduce(_int8_group, grads, err, dp_axes, dp_size, mesh)


def init_error_state(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, dict):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    return type(params)(torch.zeros_like(p, dtype=torch.float32)
                        for p in params)


__all__ = ["compress_psum_bf16", "compress_psum_int8", "dp_groups",
           "init_error_state"]
