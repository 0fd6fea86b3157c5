"""The rank mesh of the port's sharded bulk movement (port of
``repro/launch/mesh.py`` and of ``repro/models/paged.py``
``pool_shard_axes`` / ``pool_shard_count`` / ``pool_partition_spec``).

A :class:`DeviceMesh` names its axes, its shape and one ``torch.device`` per
rank, row-major over the shape.  Ranks may share a device: eight ranks on
one GPU (or on the CPU) hold eight slabs of every sharded pool, as the
reference's eight forced host devices share one CPU, and the sharded drain
moves bytes between them exactly as it would between cards.  Nothing here
asks the machine how many devices it has: the caller names them, and a
mesh is never folded to fewer ranks than its shape says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

#: the mesh axes a pool's block axis shards over, in shard order
POOL_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Axis names, shape and the device of each rank (row-major)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} for shape {self.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(int(n) < 1 for n in self.shape):
            raise ValueError(f"mesh shape {self.shape} has an empty axis")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return int(self.shape[self.axis_names.index(name)])


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   devices: Union[str, torch.device,
                                  Sequence[Union[str, torch.device]]]
                   ) -> DeviceMesh:
    """A named mesh of ``prod(shape)`` ranks on ``devices``: one device
    that every rank shares, or one per rank (row-major)."""
    n = math.prod(shape)
    if isinstance(devices, (str, torch.device)):
        devs = (torch.device(devices),) * n
    else:
        devs = tuple(torch.device(d) for d in devices)
    return DeviceMesh(tuple(axes), tuple(int(s) for s in shape), devs)


def pool_shard_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes (in shard order) that a pool's block axis shards over."""
    return tuple(a for a in POOL_AXES if a in mesh.axis_names)


def pool_shard_count(mesh: Optional[DeviceMesh]) -> int:
    """Shards of a pool's block axis: the joint size of every pool axis
    present; 1 with no mesh."""
    if mesh is None:
        return 1
    return math.prod(mesh.axis_size(a) for a in pool_shard_axes(mesh))


def pool_shard_ranks(mesh: DeviceMesh) -> Tuple[int, ...]:
    """The rank (index into ``mesh.devices``) holding each pool shard, in
    shard order.  Raises when the mesh has an axis a pool does not shard
    over: the sharded drain places every rank's slab by its shard."""
    extra = [a for a in mesh.axis_names if a not in POOL_AXES]
    if extra:
        raise ValueError(f"mesh axes {extra} are not pool axes "
                         f"{POOL_AXES}: the sharded pools need every rank")
    axes = pool_shard_axes(mesh)
    sizes = [mesh.axis_size(a) for a in axes]
    ranks = []
    for shard in range(math.prod(sizes)):
        coord, rem = {}, shard
        for a, n in zip(reversed(axes), reversed(sizes)):
            coord[a], rem = rem % n, rem // n
        rank = 0
        for a, n in zip(mesh.axis_names, mesh.shape):
            rank = rank * n + coord[a]
        ranks.append(rank)
    return tuple(ranks)


def pool_partition_spec(mesh: DeviceMesh, spec=None, block_axis: int = 0
                        ) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """The partitioning of one pool from its ``PoolSpec.sharding`` hint,
    as the reference's ``PartitionSpec`` entries: ``block_axis`` leading
    ``None``s, then the axes the block axis shards over (``None`` when
    replicated).  ``spec`` may be a PoolSpec, a raw hint or None; the hint
    ``None`` means the joint pool axes, ``()`` replicated, a tuple exactly
    those mesh axes (absent ones dropped)."""
    hint = getattr(spec, "sharding", spec)
    if hint is None:
        axes = pool_shard_axes(mesh)
    else:
        axes = tuple(a for a in hint if a in mesh.axis_names)
    return (None,) * block_axis + (axes or None,)


__all__ = ["POOL_AXES", "DeviceMesh", "make_test_mesh", "pool_shard_axes",
           "pool_shard_count", "pool_shard_ranks", "pool_partition_spec"]
