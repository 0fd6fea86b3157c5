"""Host contract layer and engine of the port: ``opcodes``, ``poolspec``,
``allocator``, ``cmdqueue``, ``journal``, ``stream``, ``rowclone`` and
``cow_cache`` (import the submodules; the package itself loads nothing, so
that the kernels can import the opcode registry without the engine)."""
