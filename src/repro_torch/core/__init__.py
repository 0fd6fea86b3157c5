"""Host contract layer and engine of the port: ``opcodes``, ``poolspec``,
``allocator``, ``cmdqueue``, ``journal``, ``stream``, ``rowclone``,
``cow_cache`` and ``sanitizer``.  The package exports the names
``repro.core`` exports, with the port's counterparts
(``from repro_torch.core import BlockRef, RowCloneEngine, ...``).

Importing the package loads only the drain sanitizer, which needs the
opcode registry and the journal's host copies, never the engine: the
kernels import the opcode registry (``repro_torch.kernels.fused_dispatch``
imports ``core.opcodes``), and the engine imports the kernels, so an
eager import of the engine here would close that cycle.  Every other
name resolves at first use, through the module ``__getattr__`` (PEP 562),
which imports its submodule then."""
from importlib import import_module

from repro_torch.core.sanitizer import (DrainSanitizer, Finding,
                                        SanitizerError, SanitizerReport,
                                        sanitize_enabled)

#: the submodule that defines each lazily resolved name
_LAZY = {
    "CommandStream": "stream", "FlushTicket": "stream",
    "AllocStats": "allocator", "OutOfBlocks": "allocator",
    "SubarrayAllocator": "allocator",
    "BUCKETS": "cmdqueue", "bucket_size": "cmdqueue",
    "partition_commands": "cmdqueue", "fold_shard_plan": "cmdqueue",
    "ShardPlan": "cmdqueue", "CommandQueue": "cmdqueue",
    "QueueStats": "cmdqueue",
    "PagedCoWCache": "cow_cache", "Sequence": "cow_cache",
    "PoolSpec": "poolspec", "BlockRef": "poolspec", "PoolGroup": "poolspec",
    "EngineStats": "rowclone", "RowCloneEngine": "rowclone",
    "TicketJournal": "journal", "JournalRecord": "journal",
    "PoolSnapshot": "journal", "AbortedFlush": "journal",
    "RecoveryError": "journal", "RecoveryReport": "journal",
    "OPCODES": "opcodes", "OpSpec": "opcodes", "opspec": "opcodes",
    "UnknownOpcodeError": "opcodes", "BITWISE_OPS": "opcodes",
    "MAX_PACK_BLOCKS": "opcodes",
}


def __getattr__(name: str):
    """Resolve an exported name from its submodule at first use."""
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    """The module's names, the lazily resolved ones included."""
    return sorted(set(globals()) | set(_LAZY))


__all__ = list(_LAZY) + ["DrainSanitizer", "Finding", "SanitizerError",
                         "SanitizerReport", "sanitize_enabled"]
