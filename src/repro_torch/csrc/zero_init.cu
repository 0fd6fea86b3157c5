// K6: BuZ bulk zero-init, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_zero_init_kernel` (src/repro/kernels/zero_init.py,
// `pallas_call` at :46, entry `zero_init_pallas`), which DMA-broadcast the
// reserved all-zero block into every listed block.  The result is the same
// when the kernel stores zero bytes without reading the zero block, and the
// traffic halves: only the writes remain.
//
// Bound on this card: bytes, blocks * block_bytes / 3.35 TB/s (writes
// only).  Each CTA zeroes one shared tile once and one thread issues bulk
// asynchronous stores from it (cp.async.bulk shared -> global), so no
// thread spends registers on the bytes.  Ids of -1 are dropped by the
// entry, so padding costs nothing.  The rows only write, so a call is
// always one wave of block_move.cuh.
#include "block_move.cuh"

// one call of K6: ids (m,) int32 or int64 (`id_bytes`); returns 0, a
// cudaError_t or kNoRowBuffer
extern "C" int rc_zero_init(const void* ids, int id_bytes, long long m,
                            void* pool, long long nblk, int layers,
                            long long page_bytes, void* counters,
                            void* rows_buf, long long rows_cap, int sms,
                            void* stream, long long* out) {
  return rc_block_move::run<true>(ids, id_bytes, m, pool, pool, nblk, nblk,
                                  layers, page_bytes, 1, counters, rows_buf,
                                  rows_cap, sms, stream, out);
}
