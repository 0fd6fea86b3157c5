"""The rank mesh of the port (port of ``repro/launch/mesh.py`` and of
``repro/models/paged.py`` ``pool_shard_axes`` / ``pool_shard_count`` /
``pool_partition_spec``): the mesh, the pool layout of the sharded bulk
movement, and the placement of a tensor over the ranks.

A :class:`DeviceMesh` names its axes, its shape and one ``torch.device`` per
rank, row-major over the shape.  Ranks may share a device: eight ranks on
one GPU (or on the CPU) hold eight slabs of every sharded pool, as the
reference's eight forced host devices share one CPU, and the sharded drain
moves bytes between them exactly as it would between cards.  Nothing here
asks the machine how many devices it has: the caller names them, and a
mesh is never folded to fewer ranks than its shape says.

A :class:`Sharding` is the reference's ``NamedSharding``: the mesh and a
spec of ``PartitionSpec`` entries (:func:`sharding_for` resolves it from
logical axes under the active rules, :func:`tree_shardings` over a tree).
:func:`place` splits a tensor into the blocks the ranks' coordinates
select, each on its rank's device, and stores a block once: ranks whose
coordinates differ only in axes the spec does not name share the copy of
the lowest of them.  :func:`gather` makes the whole tensor again.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

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

    def coords(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` (row-major) by axis name."""
        out, rem = {}, rank
        for a, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[a], rem = rem % n, rem // n
        return out


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


#: one entry of a spec: None (not sharded), a mesh axis, or a tuple of
#: axes sharded jointly (row-major in the order given)
SpecEntry = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies over ``mesh``: one spec entry per leading
    dimension (dimensions past the spec are whole)."""

    mesh: DeviceMesh
    spec: Tuple[SpecEntry, ...]

    def _axes(self, dim: int) -> Tuple[str, ...]:
        e = self.spec[dim] if dim < len(self.spec) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def counts(self, ndim: int) -> Tuple[int, ...]:
        """Blocks along each of ``ndim`` dimensions."""
        return tuple(math.prod(self.mesh.axis_size(a) for a in self._axes(i))
                     for i in range(ndim))

    def block_of(self, rank: int) -> Tuple[int, ...]:
        """The block index (one per spec entry) that ``rank`` holds."""
        coord = self.mesh.coords(rank)
        out = []
        for i in range(len(self.spec)):
            idx = 0
            for a in self._axes(i):
                idx = idx * self.mesh.axis_size(a) + coord[a]
            out.append(idx)
        return tuple(out)

    def owners(self) -> Dict[Tuple[int, ...], int]:
        """Each distinct block and the lowest rank that holds it, in
        block order."""
        out = {}
        for rank in range(self.mesh.size):
            out.setdefault(self.block_of(rank), rank)
        return dict(sorted(out.items()))

    def slices(self, block: Tuple[int, ...], shape: Sequence[int]
               ) -> Tuple[slice, ...]:
        """The index of ``block`` in a tensor of ``shape``; raises where
        a dimension does not split evenly."""
        out = []
        for i, (idx, n) in enumerate(zip(block, self.counts(len(block)))):
            if shape[i] % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split into {n} blocks")
            size = shape[i] // n
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)


class Sharded:
    """A tensor held as the blocks of its :class:`Sharding`, each on the
    device of the lowest rank that holds it (:func:`place`)."""

    def __init__(self, sharding: Sharding, shape: Sequence[int],
                 blocks: Dict[Tuple[int, ...], torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def sharding_for(mesh: DeviceMesh, shape: Sequence[int], axes) -> Sharding:
    """Logical axes -> :class:`Sharding` under the active rules, each
    rule's fallbacks tried until one divides its dimension (the
    reference's ``sharding_for``)."""
    from repro_torch.sharding.rules import logical_to_spec
    return Sharding(mesh, logical_to_spec(tuple(axes), mesh,
                                          dims=tuple(shape[:len(axes)])))


def tree_shardings(mesh: DeviceMesh, value_tree, axes_tree, *,
                   block_axis: int = 0):
    """The :class:`Sharding` of every leaf of ``value_tree`` (nested
    dicts of tensors) from the matching leaf of ``axes_tree``: a tuple of
    logical axes, or a ``PoolSpec``, which resolves through
    :func:`pool_partition_spec` with the pool's block dimension at
    ``block_axis``."""
    from repro_torch.core.poolspec import PoolSpec

    def one(v, a):
        if isinstance(a, PoolSpec):
            return Sharding(mesh, pool_partition_spec(mesh, a, block_axis))
        if isinstance(v, dict):
            return {k: one(v[k], a[k]) for k in v}
        return sharding_for(mesh, tuple(v.shape), a)

    return one(value_tree, axes_tree)


def place(x: torch.Tensor, sharding: Sharding
          ) -> Union[torch.Tensor, Sharded]:
    """``x`` (detached) split by ``sharding``: a :class:`Sharded` whose
    every block is a contiguous copy on its owner's device, or, where
    the spec shards nothing, ``x`` itself on the first rank's device."""
    x = x.detach()
    owners = sharding.owners()
    devs = sharding.mesh.devices
    if len(owners) == 1:
        return x.to(devs[0])
    return Sharded(sharding, x.shape, {
        b: x[sharding.slices(b, x.shape)].to(
            devs[r], memory_format=torch.contiguous_format, copy=True)
        for b, r in owners.items()})


def assemble(blocks: Dict[Tuple[int, ...], torch.Tensor],
             counts: Sequence[int]) -> torch.Tensor:
    """The tensor whose block grid (``counts`` blocks along each leading
    dimension) holds ``blocks``, by concatenation (differentiable)."""
    def cat(prefix: Tuple[int, ...]) -> torch.Tensor:
        dim = len(prefix)
        if dim == len(counts):
            return blocks[prefix]
        parts = [cat(prefix + (i,)) for i in range(counts[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return cat(())


def gather(x: Union[torch.Tensor, Sharded], device=None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole tensor on ``device`` (default the first block's), each
    block cast to ``dtype`` on its own device before it moves (so a bf16
    view of fp32 shards moves bf16 bytes).  Differentiable; a round trip
    through :func:`place` is bitwise."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype or x.dtype).to(device or x.device)
    first = next(iter(x.blocks.values()))
    device = device or first.device
    blocks = {b: t.to(dtype or t.dtype).to(device)
              for b, t in x.blocks.items()}
    return assemble(blocks, x.sharding.counts(len(x.sharding.spec)))


def pieces(x: Union[torch.Tensor, Sharded]) -> List[torch.Tensor]:
    """The tensors that hold ``x``: its blocks in block order, or x."""
    return list(x.blocks.values()) if isinstance(x, Sharded) else [x]


def with_pieces(x: Union[torch.Tensor, Sharded],
                tensors: Sequence[torch.Tensor]
                ) -> Union[torch.Tensor, Sharded]:
    """A value laid out as ``x`` whose :func:`pieces` are ``tensors``."""
    if isinstance(x, Sharded):
        return Sharded(x.sharding, x.shape, dict(zip(x.blocks, tensors)))
    return tensors[0]


def rank_bytes(values, mesh: DeviceMesh) -> List[int]:
    """Bytes each rank of ``mesh`` holds of ``values`` (tensors and
    :class:`Sharded`): a block counts to its owner, a whole tensor to
    rank 0."""
    out = [0] * mesh.size
    for v in values:
        if isinstance(v, Sharded):
            owners = v.sharding.owners()
            for b, t in v.blocks.items():
                out[owners[b]] += t.numel() * t.element_size()
        else:
            out[0] += v.numel() * v.element_size()
    return out


__all__ = ["POOL_AXES", "DeviceMesh", "Sharded", "Sharding", "assemble",
           "gather", "make_test_mesh", "pieces", "place",
           "pool_partition_spec", "pool_shard_axes", "pool_shard_count",
           "pool_shard_ranks", "rank_bytes", "sharding_for",
           "tree_shardings", "with_pieces"]
