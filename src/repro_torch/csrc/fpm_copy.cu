// K5a / K5b: FPM block copy, in-pool and pool-to-pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_fpm_copy_kernel` (src/repro/kernels/fpm_copy.py,
// `pallas_call` at :60, entry `fpm_copy_pallas`) and `_fpm_copy_cross_kernel`
// (`pallas_call` at :101, entry `fpm_copy_cross_pallas`): a list of
// (src, dst) block pairs is copied in one launch, dst == -1 skipping a pair
// (the host drops those rows before the launch, so padding costs no
// traffic).  In-pool copy passes the same base for source and destination.
//
// Bound on this card: bytes.  Each pair reads and writes one block; the
// least time is 2 * pairs * block_bytes / 3.35 TB/s.  The TPU kernel issued
// one HBM->HBM DMA per pair on a serial grid; here every (pair, layer,
// 32 KiB chunk) is a work item that a CTA streams with 16-byte vectors, so
// all pairs move at once and the write-after-read order is kept by the wave
// gate of block_move.cuh.
#include "block_move.cuh"

extern "C" int rc_fpm_copy(void* desc, void* counters, int grid,
                           void* stream) {
  return rc_block_move::launch<false>(desc, counters, grid, stream);
}
