"""repro_torch — the PyTorch / CUDA port of the RowClone reproduction.

A sibling of the JAX package ``repro`` (the reference, which this package
never imports).  The layout mirrors it: ``core/`` (opcode registry, pool
address space, allocator, command queue, streams, engine, CoW cache),
``kernels/`` (hand-written CUDA kernels for Hopper with their plain PyTorch
versions and the resolution rule between them), ``models/`` (the dense
decoder), ``launch/`` (the serving engine).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
