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

A placed model computes on :class:`Sharded` values as well (its weights
by ``weights.place_params``, its activations block by block through
:func:`map_blocks`), with three moves between the ranks' devices, as the
reference's GSPMD collectives would make them: :func:`take` brings any
slice of a value onto a rank from the blocks that hold it (the all-gather
of a weight's ZeRO-3 dimension, or of a K/V row range; an all-to-all
where the slice crosses another axis), and :func:`scatter_sum` sums the
partial products of a contraction split over ranks into the blocks of
another sharding (the reduce-scatter by sequence rows, or the all-reduce
where the output is not split); :func:`relayout` takes a value into
another layout.

Every move of a tensor onto a rank's device goes through :func:`to_rank`
(or :func:`to_rank_of`), work done rank by rank runs inside
:func:`rank_scope`, and a tensor made on a rank's device outside one is
marked with :func:`on_rank`: plain ``.to`` calls and no-ops, unless an op-cost
walk is active (``launch/op_cost.py`` sets :data:`WALK`), which reckons
each rank's work over ``meta`` tensors, where every rank's device is one.
:func:`make_production_mesh` gives the meshes that walk's dry-run
reckons.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

#: the mesh axes a pool's block axis shards over, in shard order
POOL_AXES = ("pod", "data", "model")

#: the active op-cost walk (``launch/op_cost.py``), or None: it places
#: the moves of :func:`to_rank` / :func:`to_rank_of` and the marks of
#: :func:`on_rank`
WALK = None


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
        """Number of ranks along the axis ``name``."""
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


def make_production_mesh(*, multi_pod: bool = False, devices="meta"
                         ) -> DeviceMesh:
    """The reference's production meshes (``repro/launch/mesh.py``):
    (16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``, every rank on ``devices``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, devices=devices)


def to_rank(t: torch.Tensor, mesh: DeviceMesh, rank: int, *,
            path: str = "other", **kw) -> torch.Tensor:
    """``t.to(mesh.devices[rank], **kw)``; under an op-cost walk, a copy
    on ``rank`` whose bytes from another rank count to ``path``."""
    if WALK is not None:
        return WALK.move(t, rank, path, **kw)
    return t.to(mesh.devices[rank], **kw)


def to_rank_of(t: torch.Tensor, like: torch.Tensor, *,
               path: str = "other") -> torch.Tensor:
    """``t.to(like.device)``; under an op-cost walk, onto ``like``'s
    rank."""
    if WALK is not None:
        return WALK.move(t, WALK.rank_of(like), path)
    return t.to(like.device)


@contextlib.contextmanager
def rank_scope(rank: int):
    """The work inside runs on ``rank``'s device: an op-cost walk counts
    it, and places what it makes, on ``rank``."""
    if WALK is None:
        yield
    else:
        with WALK.scope(rank):
            yield


def on_rank(t: torch.Tensor, rank: int) -> torch.Tensor:
    """``t``, made on ``rank``'s device; an op-cost walk marks it as that
    rank's."""
    if WALK is not None:
        WALK.tag(t, rank)
    return t


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
    device of the lowest rank that holds it (:func:`place`).  With
    ``cast``, the value is the blocks read as that dtype: :func:`take` and
    :func:`gather` cast each block's part on its owner as they read it (a
    training step's bf16 view of its fp32 masters, whose readers' grads
    then meet in fp32 on the masters)."""

    def __init__(self, sharding: Sharding, shape: Sequence[int],
                 blocks: Dict[Tuple[int, ...], torch.Tensor],
                 cast: Optional[torch.dtype] = None):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.blocks = blocks
        self.cast = cast

    @property
    def dtype(self) -> torch.dtype:
        """The value's dtype: ``cast`` where the blocks are read as
        another, else the blocks'."""
        return self.cast or next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        """Number of dimensions of the whole value."""
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
        return to_rank(x, sharding.mesh, 0, path="place")
    return Sharded(sharding, x.shape, {
        b: to_rank(x[sharding.slices(b, x.shape)], sharding.mesh, r,
                   path="place", memory_format=torch.contiguous_format,
                   copy=True)
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
    dtype = dtype or x.cast
    mesh = x.sharding.mesh
    # the rank that receives: the first block's owner, or the lowest rank
    # on ``device`` (None: a device outside the mesh)
    if device is None:
        dst = x.sharding.owners()[next(iter(x.blocks))]
    else:
        device = torch.device(device)
        dst = mesh.devices.index(device) if device in mesh.devices else None

    def move(t: torch.Tensor) -> torch.Tensor:
        t = t.to(dtype or t.dtype)
        return t.to(device) if dst is None else \
            to_rank(t, mesh, dst, path="gather")

    blocks = {b: move(t) for b, t in x.blocks.items()}
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


def map_blocks(sharding: Sharding, shape: Sequence[int], fn) -> Sharded:
    """The :class:`Sharded` of ``shape`` by ``sharding`` whose every
    distinct block is ``fn(block, slices, rank)``, computed inside
    :func:`rank_scope` of the lowest rank that holds it (``slices``: the
    block's index in the whole)."""
    shape = tuple(shape)
    blocks = {}
    for b, r in sharding.owners().items():
        with rank_scope(r):
            blocks[b] = fn(b, sharding.slices(b, shape), r)
    return Sharded(sharding, shape, blocks)


def zeros(sharding: Sharding, shape: Sequence[int], dtype: torch.dtype
          ) -> Sharded:
    """A :class:`Sharded` of zeros of ``shape`` laid out by ``sharding``,
    each block made on its owner's device (nothing whole is made)."""
    return map_blocks(sharding, shape, lambda b, sl, r: torch.zeros(
        [s.stop - s.start for s in sl] + list(shape[len(sl):]),
        dtype=dtype, device=sharding.mesh.devices[r]))


def take(x: Union[torch.Tensor, Sharded], rank: int,
         index: Sequence[slice] = (), *, mesh: Optional[DeviceMesh] = None,
         path: str = "gather") -> torch.Tensor:
    """``x[index]`` on ``rank`` (``index``: one step-1 slice per leading
    dimension, the rest whole): each block's part of the slice moves from
    its owner (a view where the owner is ``rank``; cast there first when
    ``x.cast`` says so) and the parts are joined there.  A whole tensor
    (``mesh`` then names the mesh) moves as its slice."""
    if not isinstance(x, Sharded):
        return to_rank(x[tuple(index)], mesh, rank, path=path)
    sh = x.sharding
    nd = len(sh.spec)
    ranges = [(index[i] if i < len(index) else slice(None)).indices(n)[:2]
              for i, n in enumerate(x.shape)]
    per_dim = []
    for i, n in enumerate(sh.counts(nd)):
        lo, hi = ranges[i]
        if hi <= lo:
            raise ValueError(f"empty slice {index[i]} of dimension {i} of "
                             f"{tuple(x.shape)}")
        size = x.shape[i] // n
        per_dim.append([(b, slice(max(lo, b * size) - b * size,
                                  min(hi, (b + 1) * size) - b * size))
                        for b in range(lo // size, (hi - 1) // size + 1)])
    rest = tuple(slice(lo, hi) for lo, hi in ranges[nd:])
    parts = {}
    for combo in itertools.product(*(enumerate(d) for d in per_dim)):
        parts[tuple(k for k, _ in combo)] = (
            x.blocks[tuple(b for _, (b, _) in combo)],
            tuple(s for _, (_, s) in combo) + rest)
    if WALK is not None and (len(parts) > 1 or x.cast is not None):
        return WALK.join(list(parts.values()),
                         [hi - lo for lo, hi in ranges], rank, path, x.cast)

    def part(t, index):
        if any(s.start or s.stop < n for s, n in zip(index, t.shape)):
            t = t[index]        # a view; a whole block is taken as is
        if x.cast is not None:
            t = t.to(x.cast)    # on the block's own device
        return to_rank(t, sh.mesh, rank, path=path)

    with rank_scope(rank):
        return assemble({k: part(*v) for k, v in parts.items()},
                        [len(d) for d in per_dim])


def scatter_sum(partials: Sharded, sharding: Sharding,
                dtype: torch.dtype) -> Sharded:
    """The sum over the leading dimension of ``partials`` (C, *shape), one
    partial product for each block of a contraction split over ranks,
    laid out by ``sharding`` over ``shape``.  Each block of the result is its
    slice of every partial, moved to its owner and summed there in fp32,
    then cast to ``dtype``."""
    shape = tuple(partials.shape[1:])
    return map_blocks(sharding, shape, lambda b, sl, r: take(
        partials, r, (slice(None),) + sl, path="sum").sum(
            0, dtype=torch.float32).to(dtype))


def relayout(x: Sharded, sharding: Sharding, path: str = "gather"
             ) -> Sharded:
    """``x`` laid out by ``sharding``: x itself where it lies so already,
    else each block of the new layout taken onto its owner
    (:func:`take`)."""
    if x.sharding == sharding:
        return x
    return map_blocks(sharding, x.shape, lambda b, sl, r: take(
        x, r, sl, path=path))


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


__all__ = ["POOL_AXES", "WALK", "DeviceMesh", "Sharded", "Sharding",
           "assemble", "gather", "make_production_mesh", "make_test_mesh",
           "map_blocks", "on_rank", "pieces", "place", "rank_scope",
           "scatter_sum", "take", "to_rank", "to_rank_of",
           "pool_partition_spec", "pool_shard_axes", "pool_shard_count",
           "pool_shard_ranks", "rank_bytes", "relayout", "sharding_for",
           "tree_shardings", "with_pieces", "zeros"]
