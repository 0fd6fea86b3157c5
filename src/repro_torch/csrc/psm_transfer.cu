// K7: the PSM transfer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_psm_kernel` (src/repro/kernels/psm_transfer.py,
// `pallas_call` at :74, entry `psm_transfer_pallas` :69), which pushed
// slab-local blocks into the slab of the device at a signed hop along one
// mesh axis with remote DMAs over ICI, two in flight.
//
// Contract (kernels/psm_transfer.py `check_rows` states it in Python): a
// row [table, my, src, dst, hop] copies block `src` of rank `my`'s source
// slab of `table` into block `dst` of rank (my + hop + n) % n's destination
// slab of `table`.  A block is `layers` pages of `page_bytes`; page `layer`
// of block `b` lies at base + (layer * nblk + b) * page_bytes, so a
// layer-stacked slab (L, nblk, ...) moves L strided pages per block.  The
// bytes are dtype-blind.  With ranks on several cards the destination
// bases are peer addresses (peer access enabled by `rc_enable_peer`) and
// the same code writes over NVLink.
//
// Bound on this card: bytes, 2 * rows * L * page_bytes / 3.35 TB/s (each
// row reads one block and writes one).  The TPU's depth-2 DMA pipeline is
// not carried over: every row of a call is in flight at once.
//
// Host (one C call per source card, no numpy, no device allocation): the
// entry reads the caller's raw (m, 5) int64 rows and the slab records
// (base address, blocks, card of each (table, side, rank) slab) and
//   1. refuses what `check_rows` refuses, with the first offending row it
//      names: a table, rank or hop outside the call (one pass over the
//      rows), then a block outside its slab (a second pass), then two rows
//      writing one block (WAW: the destination keys sorted, the first
//      equal pair in key order), then a row reading a block another row
//      writes (RAW: each source key searched among them, in row order).  A
//      key is a slab's identity (the order in which its (card, base
//      address) first appears, sources before destinations) and a block;
//   2. keeps the rows whose source slab lies on `card` and resolves each
//      to its source and destination block addresses (`Row`);
//   3. picks the word width (the widest access dividing the page and every
//      base) and with it the route and the chunking (block_move.cuh
//      `chunking`, a ring of kStages chunks a CTA);
//   4. launches ONCE with the rows as launch parameters (`Params`, under
//      4 KB: kRowCap rows).  Hopper takes 32,764 bytes of parameters with
//      CUDA >= 12.1; this build keeps to 4 KB, the limit of every CUDA
//      release, since every launch carries the whole struct.  A call
//      with more rows copies them from a pinned host buffer into a device
//      buffer, both kept by the wrapper per (device, stream).
// `plan_rows` in kernels/psm_transfer.py states this plan in Python;
// `rc_psm_plan` returns the library's without a launch.
//
// Device.  Work items are (row, layer, chunk); CTA b takes items b, b + grid,
// ... With 16-byte aligned pages and bases (the bulk route) one thread per
// CTA moves each chunk with bulk asynchronous copies (cp.async.bulk):
// global -> shared completing on the slot's mbarrier, then shared -> global
// as a bulk group, through a ring of kStages chunk slots with kLookahead
// loads in flight, so that the next chunks' loads overlap the last ones'
// stores.  A slot is reloaded once the store group that read it is done
// reading.  Pages or bases that are not 16-byte aligned take block_move.cuh's
// 16/8/4/2/1-byte word loop over all the CTA's threads instead: the host
// picks the route from the geometry before the launch.
//
// Ordering.  None is needed: the contract forbids a row to read a block
// another row of the call writes and two rows to write one block (both
// refused above), so the items of a call are independent.  K7 has no wave
// gate and no work counters (K1 and K5 have both): items are assigned to
// CTAs statically.
#include "block_move.cuh"

#include <algorithm>
#include <utility>

namespace {

namespace bm = rc_block_move;

constexpr int kRowCap = 169;       // rows carried in the launch parameters
constexpr int kStages = bm::kStages;
constexpr int kLookahead = 3;      // bulk loads in flight per CTA
static_assert(kLookahead < kStages, "a slot must stay free for the store");
constexpr int kSlabWords = 3;      // base address, blocks, card
constexpr int kRowWords = 5;       // table, my, src, dst, hop
// out[]: rows launched, work items, grid, chunk bytes, chunks per page,
// bulk route, word bytes, rows through the device buffer, refused row, the
// row it reads from (RAW)
constexpr int kOutWords = 10;

// return codes besides cudaError_t (which are >= 0)
constexpr int kOutside = -1;        // a table, rank or hop outside the call
constexpr int kBlockOutside = -2;   // a block outside its slab
constexpr int kWaw = -3;
constexpr int kRaw = -4;
constexpr int kNoRowBuffer = -5;

struct Row {
  const char* src;  // the source block's page 0
  char* dst;        // the destination block's page 0
  int src_nblk, dst_nblk;
};
static_assert(sizeof(Row) == 24, "row layout");

struct Params {
  const Row* rows_dev;  // the rows in device memory, else `rows`
  long long page_bytes;
  int layers, chunk, cpp, n_rows, word;
  Row rows[kRowCap];
};
static_assert(sizeof(Params) <= 4096, "launch parameters above 4 KB");

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------

struct Item {
  const char* src;
  char* dst;
  uint32_t bytes;
};

__device__ __forceinline__ Item locate(const Params& p, long long item) {
  const long long per_row = (long long)p.layers * p.cpp;
  const long long r = item / per_row;
  const long long rem = item - r * per_row;
  const long long layer = rem / p.cpp;
  const long long off = (rem - layer * p.cpp) * p.chunk;
  const long long left = p.page_bytes - off;
  const Row row = p.rows_dev ? p.rows_dev[r] : p.rows[r];
  Item it;
  it.src = row.src + layer * row.src_nblk * p.page_bytes + off;
  it.dst = row.dst + layer * row.dst_nblk * p.page_bytes + off;
  it.bytes = (uint32_t)(left < p.chunk ? left : p.chunk);
  return it;
}

// one thread: item k of this CTA loads into slot k % kStages; item k -
// (kLookahead - 1) is awaited and stored once item k's load is issued
__device__ __forceinline__ void copy_ring(const Params& p, char* smem,
                                          uint64_t* bars, long long n_items) {
  const uint32_t ring = smem_u32(smem);
  for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  char* dst[kStages];
  uint32_t bytes[kStages];
  auto store = [&](long long j) {
    const int s = (int)(j % kStages);
    bm::wait_loaded(smem_u32(&bars[s]), (uint32_t)((j / kStages) & 1));
    bm::bulk_store(dst[s], ring + s * p.chunk, bytes[s]);
  };
  long long k = 0;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x, ++k) {
    const int s = (int)(k % kStages);
    // stores of items 0 .. k - kLookahead are issued; item k - kStages's
    // must be done reading slot s
    if (k >= kStages) bm::bulk_wait_read<kStages - kLookahead>();
    const Item it = locate(p, item);
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, (int)it.bytes);
    bm::bulk_load(ring + s * p.chunk, it.src, it.bytes, bar);
    dst[s] = it.dst;
    bytes[s] = it.bytes;
    if (k >= kLookahead - 1) store(k - (kLookahead - 1));
  }
  for (long long j = k > kLookahead - 1 ? k - (kLookahead - 1) : 0; j < k;
       ++j)
    store(j);
  bm::bulk_wait_all();
}

template <bool kBulk>
__global__ void __launch_bounds__(bm::kThreads)
    psm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const long long n_items = (long long)p.n_rows * p.layers * p.cpp;
  if (kBulk) {
    if (threadIdx.x == 0) copy_ring(p, smem, bars, n_items);
    return;
  }
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item it = locate(p, item);
    bm::move_bytes<bm::kOpCopy>(p.word, it.src, nullptr, it.dst, it.bytes);
  }
}

// ---------------------------------------------------------------------------
// host: checks, plan, parameters, launch
// ---------------------------------------------------------------------------

// per-thread host scratch, kept between calls (the entries release the GIL)
struct Scratch {
  std::vector<std::pair<long long, long long>> seen;  // (card, base) -> id
  std::vector<long long> ident, src_key;
  std::vector<std::pair<long long, long long>> dst_key;  // (key, row)
  std::vector<Row> rows;
};

Scratch& scratch() {
  static thread_local Scratch t;
  return t;
}

// the slab record of (table, side, rank)
inline const long long* slab(const long long* slabs, int n, long long t,
                             int side, long long r) {
  return slabs + kSlabWords * ((t * 2 + side) * n + r);
}

// the checks and the rows of one call on `card`; returns 0 or a refusal
// code with the refused row in bad[0] (and the row it reads from in bad[1])
int plan(const long long* slabs, int n_tables, int n, const long long* rows,
         long long m, int card, int layers, long long page_bytes, int sms,
         std::vector<Row>& kept, long long* out) {
  for (int i = 0; i < kOutWords; ++i) out[i] = 0;
  out[8] = out[9] = -1;
  kept.clear();
  if (m <= 0) return 0;
  for (long long i = 0; i < m; ++i) {
    const long long* r = rows + kRowWords * i;
    if (r[0] < 0 || r[0] >= n_tables || r[1] < 0 || r[1] >= n ||
        r[4] <= -n || r[4] >= n) {
      out[8] = i;
      return kOutside;
    }
  }
  for (long long i = 0; i < m; ++i) {
    const long long* r = rows + kRowWords * i;
    const long long tgt = (r[1] + r[4] + n) % n;
    if (r[2] < 0 || r[2] >= slab(slabs, n, r[0], 0, r[1])[1] || r[3] < 0 ||
        r[3] >= slab(slabs, n, r[0], 1, tgt)[1]) {
      out[8] = i;
      return kBlockOutside;
    }
  }
  Scratch& t = scratch();
  // slab identities: first appearance of (card, base), every table's
  // sources (rank order) before every table's destinations
  const long long n_slabs = 2LL * n_tables * n;
  t.seen.clear();
  t.ident.assign(n_slabs, 0);
  for (int side = 0; side < 2; ++side)
    for (long long tab = 0; tab < n_tables; ++tab)
      for (long long r = 0; r < n; ++r) {
        const long long* s = slab(slabs, n, tab, side, r);
        const std::pair<long long, long long> key(s[2], s[0]);
        long long id = 0;
        while (id < (long long)t.seen.size() && t.seen[id] != key) ++id;
        if (id == (long long)t.seen.size()) t.seen.push_back(key);
        t.ident[(tab * 2 + side) * n + r] = id;
      }
  t.src_key.resize(m);
  t.dst_key.resize(m);
  for (long long i = 0; i < m; ++i) {
    const long long* r = rows + kRowWords * i;
    const long long tgt = (r[1] + r[4] + n) % n;
    t.src_key[i] = (t.ident[(r[0] * 2) * n + r[1]] << 40) + r[2];
    t.dst_key[i] = {(t.ident[(r[0] * 2 + 1) * n + tgt] << 40) + r[3], i};
  }
  std::sort(t.dst_key.begin(), t.dst_key.end());
  for (long long i = 1; i < m; ++i)
    if (t.dst_key[i].first == t.dst_key[i - 1].first) {
      out[8] = t.dst_key[i].second;
      return kWaw;
    }
  for (long long i = 0; i < m; ++i) {
    const auto at = std::lower_bound(
        t.dst_key.begin(), t.dst_key.end(),
        std::pair<long long, long long>(t.src_key[i], -1));
    if (at != t.dst_key.end() && at->first == t.src_key[i] &&
        at->second != i) {
      out[8] = i;
      out[9] = at->second;
      return kRaw;
    }
  }
  // the rows of this card, resolved to block addresses
  int word = 16;
  for (long long i = 0; i < n_slabs; ++i)
    while ((page_bytes % word) || (slabs[kSlabWords * i] % word)) word /= 2;
  for (long long i = 0; i < m; ++i) {
    const long long* r = rows + kRowWords * i;
    const long long* s = slab(slabs, n, r[0], 0, r[1]);
    if (s[2] != card) continue;
    const long long* d = slab(slabs, n, r[0], 1, (r[1] + r[4] + n) % n);
    Row row;
    row.src = reinterpret_cast<const char*>(s[0] + r[2] * page_bytes);
    row.dst = reinterpret_cast<char*>(d[0] + r[3] * page_bytes);
    row.src_nblk = (int)s[1];
    row.dst_nblk = (int)d[1];
    kept.push_back(row);
  }
  const bool bulk = word == 16;
  int chunk, cpp, grid;
  long long items;
  bm::chunking((int)kept.size(), layers, page_bytes, bulk, kStages, sms,
               &chunk, &cpp, &items, &grid);
  out[0] = (long long)kept.size();
  out[1] = items;
  out[2] = grid;
  out[3] = chunk;
  out[4] = cpp;
  out[5] = bulk;
  out[6] = word;
  out[7] = (long long)kept.size() > kRowCap;
  return 0;
}

template <bool kBulk>
int launch(const Params& p, int grid, cudaStream_t stream) {
  const int smem = kBulk ? kStages * p.chunk : 0;
  if (kBulk) {
    const int err = bm::allow_smem<&psm_kernel<true>>(kStages * bm::kMaxChunk);
    if (err) return err;
  }
  // the bulk copy runs on one thread of each CTA: one warp is launched
  psm_kernel<kBulk><<<grid, kBulk ? 32 : bm::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// one call of K7 for the rows whose source slab lies on card `card`: the
// checks over every row, the plan, ONE launch on `stream` (none without
// rows on that card).  `slabs`: kSlabWords int64 per (table, side, rank);
// `rows`: m raw rows of kRowWords int64.  Above kRowCap rows, `pinned`
// (host) and `dev_buf` (on `card`) hold `buf_rows` rows each, and `done`
// is an event on `card` recorded after the last copy out of `pinned`: the
// entry waits for it before rewriting `pinned` and records it again.
// Returns 0, a refusal code (out[8], out[9] name the rows) or a
// cudaError_t.
extern "C" int rc_psm_transfer(const long long* slabs, int n_tables, int n,
                               const long long* rows, long long m, int card,
                               int layers, long long page_bytes, int sms,
                               void* pinned, void* dev_buf, long long buf_rows,
                               void* done, void* stream, long long* out) {
  static thread_local Params params;
  Params& p = params;
  std::vector<Row>& kept = scratch().rows;
  const int code = plan(slabs, n_tables, n, rows, m, card, layers,
                        page_bytes, sms, kept, out);
  if (code || kept.empty()) return code;
  const long long n_rows = (long long)kept.size();
  if (n_rows > kRowCap && (!pinned || !dev_buf || !done || buf_rows < n_rows))
    return kNoRowBuffer;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != card && (err = cudaSetDevice(card)) != cudaSuccess)
    return (int)err;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  p.page_bytes = page_bytes;
  p.layers = layers;
  p.chunk = (int)out[3];
  p.cpp = (int)out[4];
  p.n_rows = (int)n_rows;
  p.word = (int)out[6];
  const size_t bytes = n_rows * sizeof(Row);
  if (n_rows <= kRowCap) {
    memcpy(p.rows, kept.data(), bytes);
    p.rows_dev = nullptr;
  } else {
    // pinned source: the copy runs in stream order, without staging; the
    // device buffer is read only by launches on `stream`, after it
    const cudaEvent_t ev = static_cast<cudaEvent_t>(done);
    err = cudaEventSynchronize(ev);
    if (err == cudaSuccess) {
      memcpy(pinned, kept.data(), bytes);
      err = cudaMemcpyAsync(dev_buf, pinned, bytes, cudaMemcpyHostToDevice,
                            st);
    }
    if (err == cudaSuccess) err = cudaEventRecord(ev, st);
    p.rows_dev = static_cast<const Row*>(dev_buf);
  }
  int rc = (int)err;
  if (err == cudaSuccess)
    rc = out[5] ? launch<true>(p, (int)out[2], st)
                : launch<false>(p, (int)out[2], st);
  if (prev != card) cudaSetDevice(prev);
  return rc;
}

// the plan of one call without a launch: `rows_out` takes the kept rows as
// the kernel reads them (`Row`, 3 int64 words each; room for `cap`)
extern "C" int rc_psm_plan(const long long* slabs, int n_tables, int n,
                           const long long* rows, long long m, int card,
                           int layers, long long page_bytes, int sms,
                           long long* rows_out, long long cap,
                           long long* out) {
  std::vector<Row>& kept = scratch().rows;
  const int code = plan(slabs, n_tables, n, rows, m, card, layers,
                        page_bytes, sms, kept, out);
  if (code) return code;
  if ((long long)kept.size() > cap) return kNoRowBuffer;
  memcpy(rows_out, kept.data(), kept.size() * sizeof(Row));
  return 0;
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
  const long long c[] = {kRowCap, kStages, kLookahead, kSlabWords,
                         kRowWords, (long long)sizeof(Row),
                         (long long)sizeof(Params), kOutWords};
  for (int i = 0; i < 8; ++i) out[i] = c[i];
}
