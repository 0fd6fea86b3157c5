"""Host contract layer and engine of the port: ``opcodes``, ``poolspec``,
``allocator``, ``cmdqueue``, ``journal``, ``stream``, ``rowclone``,
``cow_cache`` and ``sanitizer`` (import the submodules).  The package
itself loads only the drain sanitizer's names, as ``repro.core`` exports
them: the sanitizer needs the opcode registry and the journal's host
copies, never the engine, so the kernels can still import the opcode
registry without the engine."""
from repro_torch.core.sanitizer import (DrainSanitizer, Finding,
                                        SanitizerError, SanitizerReport,
                                        sanitize_enabled)

__all__ = ["DrainSanitizer", "Finding", "SanitizerError", "SanitizerReport",
           "sanitize_enabled"]
