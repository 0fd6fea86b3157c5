// K7: the PSM transfer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_psm_kernel` (src/repro/kernels/psm_transfer.py,
// `pallas_call` at :74, entry `psm_transfer_pallas` :69), which pushed
// slab-local blocks into the slab of the device at a signed hop along one
// mesh axis with remote DMAs over ICI, two in flight.
//
// Contract (kernels/psm_transfer.py states and checks it on the host): a
// row [table, my, src, dst, hop] copies block `src` of rank `my`'s source
// slab of `table` into block `dst` of rank (my + hop + n) % n's destination
// slab of `table`.  The slabs are addressed through records in device
// memory, one per (table, rank): source base, source blocks, destination
// base, destination blocks.  A block is `layers` pages of `page_bytes`;
// page `layer` of block `b` lies at base + (layer * nblk + b) * page_bytes,
// so a layer-stacked slab (L, nblk, ...) moves L strided pages per block.
// The bytes are dtype-blind.  On one card every base is local memory; with
// ranks on several cards the destination bases are peer addresses (peer
// access enabled by `rc_enable_peer`) and the same code writes over NVLink.
//
// Design: work items are (row, layer, chunk of at most kChunk bytes); CTAs
// of 128 threads take items grid-stride and move each with the word loop of
// block_move.cuh (16-byte words when the page and every base allow it).
// All rows run at once: that is the card's version of PIPELINE_DEPTH.  No
// row reads a block another row writes (refused on the host), so the items
// need no order.  The host entry copies the records and rows into a device
// buffer with one asynchronous copy on the stream and launches once.
//
// Bound on this card: bytes, 2 * rows * L * page_bytes / 3.35 TB/s.
#include "block_move.cuh"

namespace {

constexpr int kChunk = 16 * 1024;
constexpr int kCtasPerSm = 8;
constexpr int kRecordWords = 4;
constexpr int kRowWords = 5;

__global__ void __launch_bounds__(rc_block_move::kThreads)
    psm_kernel(const long long* __restrict__ rec,
               const long long* __restrict__ rows, long long n_rows, int n,
               int layers, long long page_bytes, int chunk, int cpp,
               int word) {
  const long long per_row = (long long)layers * cpp;
  const long long n_items = n_rows * per_row;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long r = item / per_row;
    const long long rem = item - r * per_row;
    const long long layer = rem / cpp;
    const long long off = (rem - layer * cpp) * (long long)chunk;
    const long long* row = rows + kRowWords * r;
    const int table = (int)row[0];
    const int my = (int)row[1];
    const int target = (int)((my + row[4] + n) % n);
    const long long* s = rec + kRecordWords * ((long long)table * n + my);
    const long long* d = rec + kRecordWords * ((long long)table * n + target);
    const char* src = reinterpret_cast<const char*>(s[0]) +
                      (layer * s[1] + row[2]) * page_bytes + off;
    char* dst = reinterpret_cast<char*>(d[2]) +
                (layer * d[3] + row[3]) * page_bytes + off;
    const long long left = page_bytes - off;
    rc_block_move::move_bytes<rc_block_move::kOpCopy>(
        word, src, nullptr, dst, left < chunk ? left : chunk);
  }
}

}  // namespace

// one call of K7 on card `device`: `host` holds `rec_words` int64 of slab
// records, then n_rows rows of kRowWords int64; both go to `dev_buf`
// (`dev_cap` bytes) on `stream`, then ONE launch.  out: rows, items, grid,
// chunk.  Returns 0 or a cudaError_t.
extern "C" int rc_psm_transfer(const long long* host, long long rec_words,
                               long long n_rows, int n, int layers,
                               long long page_bytes, int word, void* dev_buf,
                               long long dev_cap, int device, int sms,
                               void* stream, long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = 0;
  if (n_rows <= 0) return 0;
  const size_t bytes = (size_t)(rec_words + n_rows * kRowWords) *
                       sizeof(long long);
  if ((long long)bytes > dev_cap) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // pageable source: the copy is staged before cudaMemcpyAsync returns
  err = cudaMemcpyAsync(dev_buf, host, bytes, cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess) {
    const int chunk = page_bytes < kChunk ? (int)page_bytes : kChunk;
    const int cpp = (int)((page_bytes + chunk - 1) / chunk);
    const long long items = n_rows * layers * cpp;
    const long long cap = (long long)sms * kCtasPerSm;
    const int grid = (int)(items < cap ? items : cap);
    const long long* rec = static_cast<const long long*>(dev_buf);
    psm_kernel<<<grid, rc_block_move::kThreads, 0, st>>>(
        rec, rec + rec_words, n_rows, n, layers, page_bytes, chunk, cpp,
        word);
    err = cudaGetLastError();
    out[0] = n_rows;
    out[1] = items;
    out[2] = grid;
    out[3] = chunk;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// lets card `device` write card `peer`'s memory; enabling twice is fine
extern "C" int rc_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// the design constants the Python side states (kernels/psm_transfer.py)
extern "C" void rc_psm_constants(long long* out) {
  out[0] = kChunk;
  out[1] = kCtasPerSm;
  out[2] = kRecordWords;
  out[3] = kRowWords;
}
