// K6: BuZ bulk zero-init, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_zero_init_kernel` (src/repro/kernels/zero_init.py,
// `pallas_call` at :46, entry `zero_init_pallas`), which DMA-broadcast the
// reserved all-zero block into every listed block.  The result is the same
// when the kernel stores zero bytes without reading the zero block, and the
// traffic halves: only the writes remain.
//
// Bound on this card: bytes, blocks * block_bytes / 3.35 TB/s (writes
// only).  Ids of -1 are dropped on the host, so padding costs nothing.  The
// rows only write, so a call is always one wave of block_move.cuh.
#include "block_move.cuh"

extern "C" int rc_zero_init(void* desc, void* counters, int grid,
                            void* stream) {
  return rc_block_move::launch<true>(desc, counters, grid, stream);
}
