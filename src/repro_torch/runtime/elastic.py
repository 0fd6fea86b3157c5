"""Elastic scaling of a training run (port of ``repro/runtime/elastic.py``):
re-mesh on a change of the healthy ranks, reshard from a checkpoint.

When the healthy set changes, the driver (a) picks the largest mesh the
survivors allow, keeping the ``model`` axis (the tensor-parallel degree
is baked into the layout; the data-parallel degree shrinks or grows), (b)
restores the last checkpoint placed for the new mesh, and (c) keeps the
global batch by accumulating more microbatches where the data-parallel
degree shrank.  The devices of the new mesh are named by the caller:
nothing here asks the machine how many it has.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple, Union

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import DeviceMesh, make_test_mesh


@dataclasses.dataclass
class ElasticDecision:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dp_size: int
    microbatches: int          # to preserve the global batch


def plan_remesh(n_devices: int, model_parallel: int, global_batch: int,
                old_dp: int, multi_pod: bool = False) -> ElasticDecision:
    """The largest (dp, tp) grid with tp == ``model_parallel`` that fits
    ``n_devices``, and the microbatches that keep the global batch where
    dp shrank (the reference's arithmetic and errors)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices")
    dp = n_devices // model_parallel
    micro = max(1, math.ceil(old_dp / dp))
    if multi_pod and dp % 2 == 0:
        return ElasticDecision((2, dp // 2, model_parallel),
                               ("pod", "data", "model"), dp, micro)
    return ElasticDecision((dp, model_parallel), ("data", "model"), dp, micro)


def build_mesh(decision: ElasticDecision,
               devices: Union[str, torch.device,
                              Sequence[Union[str, torch.device]]]
               ) -> DeviceMesh:
    """The decision's mesh over ``devices``: one device every rank
    shares, or one per rank (row-major)."""
    return make_test_mesh(decision.mesh_shape, decision.axis_names,
                          devices=devices)


def elastic_restore(ckpt: CheckpointManager, example_state,
                    new_mesh: DeviceMesh, sharding_fn: Callable):
    """The latest checkpoint placed for ``new_mesh``:
    ``sharding_fn(new_mesh)`` gives the tree of ``launch.mesh.Sharding``
    matching the state.  Returns ``(state, step)``."""
    return ckpt.restore(example_state, shardings=sharding_fn(new_mesh))


__all__ = ["ElasticDecision", "build_mesh", "elastic_restore",
           "plan_remesh"]
