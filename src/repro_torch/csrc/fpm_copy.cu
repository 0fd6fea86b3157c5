// K5a / K5b: FPM block copy, in-pool and pool-to-pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_fpm_copy_kernel` (src/repro/kernels/fpm_copy.py,
// `pallas_call` at :60, entry `fpm_copy_pallas`) and `_fpm_copy_cross_kernel`
// (`pallas_call` at :101, entry `fpm_copy_cross_pallas`): a list of
// (src, dst) block pairs is copied in one launch, dst == -1 skipping a pair
// (the entry drops those rows before the launch, so padding costs no
// traffic).  In-pool copy passes the same base for source and destination.
//
// Bound on this card: bytes.  Each pair reads and writes one block; the
// least time is 2 * pairs * block_bytes / 3.35 TB/s.  The TPU kernel issued
// one HBM->HBM DMA per pair on a serial grid; here every (pair, layer,
// chunk) is a work item a CTA moves with two bulk asynchronous copies
// (global -> shared -> global, one thread, a 4-stage ring), all pairs at
// once, and the write-after-read order is kept by the wave gate of
// block_move.cuh.  The host schedule runs in this library, so a call is
// one C call and one launch with the rows as launch parameters.
#include "block_move.cuh"

// one call of K5a / K5b (see block_move.cuh `run`): ids (m, 2) int32 or
// int64 (`id_bytes`); returns 0, a cudaError_t, or kRaw / kWaw / kNoRowBuffer
extern "C" int rc_fpm_copy(const void* ids, int id_bytes, long long m,
                           void* dst, const void* src, long long dst_nblk,
                           long long src_nblk, int layers,
                           long long page_bytes, int same_pool,
                           void* counters, void* rows_buf,
                           long long rows_cap, int sms, void* stream,
                           long long* out) {
  return rc_block_move::run<false>(ids, id_bytes, m, dst, src, dst_nblk,
                                   src_nblk, layers, page_bytes, same_pool,
                                   counters, rows_buf, rows_cap, sms, stream,
                                   out);
}

// the host schedule alone, for checks: the (n, 3) rows as the kernel gets
// them into `rows_out` (room for 3 * m ints) and `out` as `run` fills it;
// width 1 plans K6's (m,) ids
extern "C" int rc_block_plan(const void* ids, int id_bytes, long long m,
                             int width, long long n_src, long long n_dst,
                             int same_pool, int layers, long long page_bytes,
                             int bulk, int sms, int* rows_out,
                             long long* out) {
  std::vector<int> rows;
  rc_block_move::Params* p = new rc_block_move::Params;
  const int code =
      id_bytes == 4
          ? rc_block_move::plan(static_cast<const int32_t*>(ids), m, width,
                                n_src, n_dst, same_pool != 0, layers,
                                page_bytes, bulk != 0, width == 1, sms, rows,
                                p, out)
          : rc_block_move::plan(static_cast<const int64_t*>(ids), m, width,
                                n_src, n_dst, same_pool != 0, layers,
                                page_bytes, bulk != 0, width == 1, sms, rows,
                                p, out);
  delete p;
  if (!code && !rows.empty())
    memcpy(rows_out, rows.data(), rows.size() * sizeof(int));
  return code;
}

// the design constants the Python side states (kernels/fpm_copy.py)
extern "C" void rc_block_move_constants(long long* out) {
  using namespace rc_block_move;
  const long long c[] = {kRowCap, kStages, kMinChunk, kMaxChunk, kItemsPerSm,
                         kMaxCtasPerSm, kSmemPerSm, (long long)sizeof(Params)};
  for (int i = 0; i < 8; ++i) out[i] = c[i];
}
