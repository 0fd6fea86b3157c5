"""Opcode contract registry of the PyTorch port — one entry per opcode.

A copy of ``repro/core/opcodes.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_contract.py`` pins it to the reference field
by field.  An :class:`OpSpec` declares each opcode's mnemonic, source
arity and operand addressing (primary-space id, global ``base[pool] +
block`` id, or the two-source ``a * total + b`` packing), whether its
destination may name a staging pool, and whether it is compute or
padding.  The command queue's hazard keys, the WAR spacing, the wave
schedule of the CUDA drain and the plain drain all derive from it:

* :func:`row_rw` — the ``(reads, writes)`` hazard keys of one table row;
* :data:`BITWISE_OPS` / :data:`PLAIN_COPY_OPS` / :data:`OPCODE_NAMES`;
* :func:`pack_bitwise_src` / :func:`unpack_bitwise_src` with the int32
  bound :data:`MAX_PACK_BLOCKS` enforced on every decode.

Stdlib only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

#: opcode values — the ``(m, 3)`` table's first column (see the table in
#: kernels/fused_dispatch.py's module docstring)
OP_NOP = -1
OP_FPM_COPY = 0
OP_PSM_COPY = 1
OP_BASELINE_COPY = 2
OP_ZERO_INIT = 3
OP_CROSS_POOL_COPY = 4
OP_AND = 5
OP_OR = 6
OP_NOT = 7

#: hazard-key pool index standing for "every primary pool" (plain opcodes
#: move the named block in all of them at once)
ALL_PRIMARY = -1

#: largest address-space size whose two-source packing fits int32
#: (``MAX_PACK_BLOCKS ** 2 - 1 <= 2**31 - 1``)
MAX_PACK_BLOCKS = 46340

_INT32_MAX = 2 ** 31 - 1


class UnknownOpcodeError(ValueError):
    """An opcode value with no :data:`OPCODES` registry entry reached a
    decode path — a new opcode was added without declaring its contract
    (or a table row was corrupted)."""


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """The declarative contract of ONE opcode.

    ``src_kind`` / ``dst_kind`` name the operand addressing rule:

    * ``"none"`` — the field is unused (``-1`` by convention).
    * ``"primary"`` — a primary-address-space block id; the command
      touches that block in EVERY primary pool (hazard pool key
      :data:`ALL_PRIMARY`).
    * ``"global"`` — a PoolGroup global id ``base[pool] + block``
      (core/poolspec.py), naming exactly one ``(pool, block)``.
    * ``"packed"`` — TWO global ids packed ``a * total + b``
      (:func:`pack_bitwise_src`); the row reads both.

    ``staging_dst_ok`` is the staging-pool legality rule: may ``dst``
    resolve to a non-primary (staging/spill) pool?  Plain opcodes may
    not — staged bytes enter and leave staging pools exclusively through
    global-id rows.  ``arity`` counts source operands (0 for zero-init
    and padding, 1 for copies, 2 for the bitwise compute rows).
    ``is_padding`` rows (``OP_NOP``) carry no operands at all: a
    well-formed NOP row is exactly ``(-1, -1, -1)`` — also the WAR
    spacer the overlapped drain relies on.  ``is_compute`` marks the
    Ambit-style rows that combine sources instead of moving one."""

    value: int
    mnemonic: str
    arity: int
    src_kind: str          # "none" | "primary" | "global" | "packed"
    dst_kind: str          # "none" | "primary" | "global"
    staging_dst_ok: bool
    is_compute: bool = False
    is_padding: bool = False

    def __post_init__(self):
        assert self.src_kind in ("none", "primary", "global", "packed")
        assert self.dst_kind in ("none", "primary", "global")
        assert (self.arity == 2) == (self.src_kind == "packed")

    @property
    def constant_name(self) -> str:
        """The ``OP_*`` constant naming this opcode in source."""
        return "OP_" + self.mnemonic.upper()


#: the registry: opcode value -> contract.  EVERY decode path in the tree
#: derives from this dict; adding an opcode starts here.
OPCODES: Dict[int, OpSpec] = {s.value: s for s in (
    OpSpec(OP_NOP, "nop", 0, "none", "none", False, is_padding=True),
    OpSpec(OP_FPM_COPY, "fpm_copy", 1, "primary", "primary", False),
    OpSpec(OP_PSM_COPY, "psm_copy", 1, "primary", "primary", False),
    OpSpec(OP_BASELINE_COPY, "baseline_copy", 1, "primary", "primary",
           False),
    OpSpec(OP_ZERO_INIT, "zero_init", 0, "none", "primary", False),
    OpSpec(OP_CROSS_POOL_COPY, "cross_pool_copy", 1, "global", "global",
           True),
    OpSpec(OP_AND, "and", 2, "packed", "global", True, is_compute=True),
    OpSpec(OP_OR, "or", 2, "packed", "global", True, is_compute=True),
    OpSpec(OP_NOT, "not", 2, "packed", "global", True, is_compute=True),
)}

#: opcode value -> mnemonic (derived; display + benchmarks)
OPCODE_NAMES: Dict[int, str] = {v: s.mnemonic for v, s in OPCODES.items()}

#: ``OP_*`` constant name -> value (derived; the names source identifiers
#: use)
CONSTANT_NAMES: Dict[str, int] = {s.constant_name: v
                                  for v, s in OPCODES.items()}

#: two-source compute rows (Ambit triple-row activation analogue) —
#: derived from the registry's ``is_compute`` flag
BITWISE_OPS: Tuple[int, ...] = tuple(sorted(
    v for v, s in OPCODES.items() if s.is_compute))

#: single-source primary-space copies (FPM/PSM/baseline) — the kernel and
#: reference switch on this set as one branch
PLAIN_COPY_OPS: Tuple[int, ...] = tuple(sorted(
    v for v, s in OPCODES.items()
    if s.arity == 1 and s.src_kind == "primary"))


def opspec(op: int) -> OpSpec:
    """Look up the :class:`OpSpec` contract for opcode ``op`` (raises
    :class:`UnknownOpcodeError` for values outside the registry)."""
    try:
        return OPCODES[int(op)]
    except KeyError:
        raise UnknownOpcodeError(
            f"opcode {op} has no OpSpec registry entry — declare its "
            "contract in core/opcodes.py before issuing it") from None


def check_pack_total(total: int) -> None:
    """Validate an address-space size against the int32 packing bound.

    Enforced on EVERY pack/unpack — engine construction, the
    CommandQueue's hazard decodes (``enqueue``/``retire``), journal
    replay, and the ShardPlan partitioner — not just at engine
    construction."""
    if total > MAX_PACK_BLOCKS:
        raise ValueError(
            f"bitwise srcB packing overflows int32: address space has "
            f"{total} blocks (> {MAX_PACK_BLOCKS}, whose square is the "
            "int32 ceiling) — shrink the pool group or split it")


def pack_bitwise_src(a: int, b: int, total: int) -> int:
    """Pack two global source ids into one int32 src field: ``a*total+b``.

    ``total`` is the address-space size the packing runs over (the
    PoolGroup's ``total_blocks`` globally, a slab-local stacked total
    inside a ShardPlan) and is bound-checked on every call — see
    :func:`check_pack_total`."""
    check_pack_total(total)
    return a * total + b


def unpack_bitwise_src(src: int, total: int) -> Tuple[int, int]:
    """Invert :func:`pack_bitwise_src` → ``(a, b)`` global ids, validating
    both the packing bound and that ``src`` lies inside the ``total²`` id
    square (a corrupted row fails here with a descriptive error instead
    of silently aliasing another block)."""
    check_pack_total(total)
    src = int(src)
    if not 0 <= src < total * total:
        raise ValueError(
            f"packed bitwise src {src} outside the {total}x{total} "
            "two-source id space — mis-packed or corrupted row")
    return src // total, src % total


def row_rw(op: int, s: int, d: int,
           locate: Callable[[int], Tuple[int, int]],
           total: Optional[int] = None
           ) -> Tuple[Tuple[Tuple[int, int], ...],
                      Tuple[Tuple[int, int], ...]]:
    """The ``(reads, writes)`` hazard keys of one table row, each a tuple
    of ``(pool, block)`` with :data:`ALL_PRIMARY` meaning every primary
    pool — derived entirely from the opcode's :class:`OpSpec`.

    ``locate`` decodes global ids for whatever address space the row
    lives in (the PoolGroup's global ids, or a ShardPlan slab's local
    prefix-sum ids); ``total`` is that space's size, required whenever a
    packed two-source row can appear.  Padding rows carry no operands
    and raise — callers skip ``op < 0`` rows before decoding."""
    sp = opspec(op)
    if sp.is_padding:
        raise ValueError("padding rows (OP_NOP) carry no hazard keys")
    if sp.src_kind == "packed":
        if total is None:
            raise ValueError("bitwise row needs the packing total to "
                             "decode its two sources")
        a, b = unpack_bitwise_src(s, total)
        reads = (locate(a),) if a == b else (locate(a), locate(b))
    elif sp.src_kind == "global":
        reads = (locate(s),)
    elif sp.src_kind == "primary":
        reads = ((ALL_PRIMARY, s),)
    else:
        reads = ()
    if sp.dst_kind == "global":
        writes = (locate(d),)
    else:
        writes = ((ALL_PRIMARY, d),)
    return reads, writes


def keys_clash(a: Tuple[int, int], b: Tuple[int, int],
               primary: Tuple[bool, ...]) -> bool:
    """Do two ``(pool, block)`` hazard keys touch overlapping bytes?
    :data:`ALL_PRIMARY` expands to the primary pool set on either side; a
    staging-pool key only collides with an exact pool match."""
    pa, ba = a
    pb, bb = b
    if ba != bb:
        return False
    if pa == pb:
        return True
    if pa == ALL_PRIMARY:
        return primary[pb]
    if pb == ALL_PRIMARY:
        return primary[pa]
    return False


__all__ = [
    "OP_NOP", "OP_FPM_COPY", "OP_PSM_COPY", "OP_BASELINE_COPY",
    "OP_ZERO_INIT", "OP_CROSS_POOL_COPY", "OP_AND", "OP_OR", "OP_NOT",
    "ALL_PRIMARY", "MAX_PACK_BLOCKS", "OPCODES", "OPCODE_NAMES",
    "CONSTANT_NAMES", "BITWISE_OPS", "PLAIN_COPY_OPS", "OpSpec",
    "UnknownOpcodeError", "opspec", "check_pack_total",
    "pack_bitwise_src", "unpack_bitwise_src", "row_rw", "keys_clash",
]
