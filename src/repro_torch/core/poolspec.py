"""Pool address space of the PyTorch port — ``PoolSpec``, ``BlockRef``,
``PoolGroup``.

A copy of ``repro/core/poolspec.py``.  A :class:`PoolGroup` orders the
pools and owns the global-id arithmetic: ``BlockRef(p, b)`` encodes as
``base[p] + b``, where ``base`` is the prefix sum of the per-pool block
counts, so a small staging ring and a large KV pool share one command
table.  Stdlib only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Layout descriptor for one block pool.

    ``nblk`` is *per pool* — staging pools may be much smaller than the
    primary pools they promote into (the staging-ring configuration that
    halves serving memory).  ``block_shape``/``dtype`` describe one block
    (every axis except the block axis) and are metadata: the arrays
    themselves live in the engine's pool dict.  ``role`` is ``"primary"``
    (plain opcodes move the named block here), ``"staging"`` (reachable
    only through cross-pool commands; prefill pages park here before
    promotion), or ``"spill"`` (also cross-pool-only; the background
    checkpoint stream's snapshot destination — see
    checkpoint/pool_checkpoint.py).  Staging and spill specs name their
    primary twin in ``paired``.  ``sharding`` is an optional hint naming
    the mesh axes the block axis shards over (the serving layout uses
    ``("pod", "data", "model")``)."""

    name: str
    nblk: int
    block_shape: Tuple[int, ...] = ()
    dtype: Optional[object] = None
    role: str = "primary"
    paired: Optional[str] = None
    sharding: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.nblk <= 0:
            raise ValueError(f"pool {self.name!r}: nblk={self.nblk} <= 0")
        if self.role not in ("primary", "staging", "spill"):
            raise ValueError(f"pool {self.name!r}: unknown role "
                             f"{self.role!r}")
        if self.role in ("staging", "spill") and not self.paired:
            raise ValueError(f"{self.role} pool {self.name!r} must name "
                             "its primary twin in `paired`")


@dataclasses.dataclass(frozen=True, order=True)
class BlockRef:
    """An addressed block: ``(pool name, block id local to that pool)``.

    The canonical operand of the engine's copy/init calls — resolved to a
    global table id through the engine's :class:`PoolGroup`."""

    pool: str
    block: int


class PoolGroup:
    """Ordered pool specs + the prefix-sum base-offset table.

    The group is the single owner of global-id arithmetic: a command table
    row addressing ``BlockRef(p, b)`` encodes it as ``base(p) + b``; the
    inverse (:meth:`locate`) recovers ``(pool index, local block)`` from a
    global id.  Order matters — it is the pool-argument order of every
    fused launch, and the base offsets are the running sums of ``nblk`` in
    that order."""

    def __init__(self, specs: Sequence[PoolSpec]):
        specs = tuple(specs)
        if not specs:
            raise ValueError("PoolGroup needs at least one PoolSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        for s in specs:
            if s.role in ("staging", "spill"):
                twin = next((p for p in specs if p.name == s.paired), None)
                if twin is None or twin.role != "primary":
                    raise ValueError(
                        f"{s.role} pool {s.name!r} pairs with "
                        f"{s.paired!r}, which is not a primary pool")
        # plain opcodes carry ONE block id for every primary pool, so the
        # primary pools must share a single address space; enforcing it
        # here protects every bare-group consumer (partition_commands,
        # the kernels), not just the engine constructor
        primary_nblks = {s.nblk for s in specs if s.role == "primary"}
        if len(primary_nblks) > 1:
            raise ValueError(
                "primary pools must share one block count (plain opcodes "
                "address them with a single id): "
                f"{[(s.name, s.nblk) for s in specs if s.role == 'primary']}")
        self.specs = specs
        self._index: Dict[str, int] = {s.name: i for i, s in
                                       enumerate(specs)}
        bases = []
        run = 0
        for s in specs:
            bases.append(run)
            run += s.nblk
        self._bases: Tuple[int, ...] = tuple(bases)
        self._total = run

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self) -> Iterator[PoolSpec]:
        return iter(self.specs)

    def __getitem__(self, key: Union[int, str]) -> PoolSpec:
        if isinstance(key, str):
            return self.specs[self._index[key]]
        return self.specs[key]

    @property
    def names(self) -> Tuple[str, ...]:
        """Pool names in table order."""
        return tuple(s.name for s in self.specs)

    @property
    def bases(self) -> Tuple[int, ...]:
        """Per-pool global-id base offsets (prefix sums of ``nblk``)."""
        return self._bases

    @property
    def nblks(self) -> Tuple[int, ...]:
        """Per-pool block counts, in table order."""
        return tuple(s.nblk for s in self.specs)

    @property
    def total_blocks(self) -> int:
        """Size of the global id space (sum of every pool's ``nblk``)."""
        return self._total

    @property
    def primary(self) -> Tuple[bool, ...]:
        """Per-pool role vector: True where plain opcodes land."""
        return tuple(s.role == "primary" for s in self.specs)

    @property
    def n_primary(self) -> int:
        """Number of primary pools."""
        return sum(self.primary)

    @property
    def primary_names(self) -> Tuple[str, ...]:
        """Names of the primary pools, in table order."""
        return tuple(s.name for s in self.specs if s.role == "primary")

    @property
    def staging_map(self) -> Dict[str, str]:
        """staging pool name -> its paired primary pool name."""
        return {s.name: s.paired for s in self.specs
                if s.role == "staging"}

    def index(self, name: str) -> int:
        """Table position of pool ``name``."""
        return self._index[name]

    # ------------------------------------------------------------------
    def base(self, pool: Union[int, str]) -> int:
        """Global-id base offset of one pool."""
        if isinstance(pool, str):
            pool = self._index[pool]
        return self._bases[pool]

    def gid(self, ref: BlockRef) -> int:
        """Encode a :class:`BlockRef` as a global table id, validating the
        block against the pool's own ``nblk``."""
        i = self._index[ref.pool]
        b = int(ref.block)
        if not 0 <= b < self.specs[i].nblk:
            raise ValueError(
                f"block {b} out of range for pool {ref.pool!r} "
                f"(nblk={self.specs[i].nblk})")
        return self._bases[i] + b

    def locate(self, gid: int) -> Tuple[int, int]:
        """Inverse of :meth:`gid`: global id -> (pool index, local block)."""
        gid = int(gid)
        if not 0 <= gid < self._total:
            raise ValueError(f"global id {gid} outside the group's "
                             f"{self._total}-block address space")
        # linear scan: pool counts are tiny (2-8), and this is host-side
        for i in range(len(self.specs) - 1, -1, -1):
            if gid >= self._bases[i]:
                return i, gid - self._bases[i]
        raise AssertionError("unreachable")

    def ref(self, gid: int) -> BlockRef:
        """Global id -> :class:`BlockRef`."""
        i, b = self.locate(gid)
        return BlockRef(self.specs[i].name, b)

    # ------------------------------------------------------------------
    @classmethod
    def from_pools(cls, pools: Dict[str, object], *, block_axis: int = 0,
                   staging: Optional[Dict[str, str]] = None,
                   sharding: Optional[Tuple[str, ...]] = None
                   ) -> "PoolGroup":
        """Build a group from a name -> array dict (the engine's legacy
        constructor input): per-pool ``nblk`` from each array's block
        axis, roles from the ``staging`` map."""
        staging = staging or {}
        specs = []
        for name, arr in pools.items():
            shape = list(arr.shape)
            nblk = shape.pop(block_axis)
            specs.append(PoolSpec(
                name=name, nblk=int(nblk), block_shape=tuple(shape),
                dtype=arr.dtype,
                role="staging" if name in staging else "primary",
                paired=staging.get(name), sharding=sharding))
        return cls(specs)


__all__ = ["PoolSpec", "BlockRef", "PoolGroup"]
