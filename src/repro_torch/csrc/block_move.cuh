// Shared body of K5 (csrc/fpm_copy.cu) and K6 (csrc/zero_init.cu): one
// launch moves (or zeroes) a list of blocks of one pool, in place, and the
// host schedule that prepares it.  K1 (csrc/fused_dispatch.cu) drains its
// command tables with the device pieces below (bulk copies, the ring's
// waits, the wave gate, the word loop, `leave`) and the same chunking; K7
// (csrc/psm_transfer.cu) moves its rows with the bulk copies, the ring's
// waits, the word loop and the same chunking, without gate or counters.
//
// A block is `layers` pages of `page_bytes` each; page `layer` of block `b`
// lies at base + (layer * nblk + b) * page_bytes, so a layer-stacked pool
// (L, nblk, ...) moves L strided pages per block and a flat pool is the
// case layers == 1.  The kernel only streams bytes and is dtype-blind.
//
// Host (one C call per kernel call, no numpy, no device allocation): the
// entry reads the caller's raw (m, 2) [src, dst] ids (int32 or int64; (m,)
// dst ids for K6), drops rows whose destination is out of range (-1
// padding), clips sources into the pool, gives each row a wave (0, or 1 +
// the largest wave of an EARLIER row reading its destination), refuses a
// RAW or WAW pair, sorts the rows by wave and passes them to the kernel as
// launch parameters (`Params`, under 4 KB: `kRowCap` rows).  A call with
// more live rows copies them into a device buffer the caller provides and
// launches the same kernel over it.  The rules are those of
// repro_torch/kernels/fpm_copy.py `_live_pairs` and `pair_waves`; its
// `launch_rows` and `chunking` state the parameter layout in Python.
//
// Device.  Work items are (row, layer, chunk); the chunk follows the call
// (about kItemsPerSm items per SM, 4-32 KiB, a multiple of 16 bytes).  CTAs
// take items in order from a ticket counter.  With 16-byte aligned pages
// one thread per CTA moves each chunk with bulk asynchronous copies
// (cp.async.bulk): global -> shared completing on an mbarrier, then shared
// -> global as a bulk group, through a ring of kStages chunk buffers so
// that one chunk's load overlaps the previous chunks' stores.  K6 zeroes
// one shared tile once and issues only bulk stores from it.  A page that
// is not 16-byte aligned takes a 16/8/4/2/1-byte word loop over all the
// CTA's threads instead.
//
// Ordering.  Sources must see the pre-call state.  A row may write a block
// an earlier row reads (WAR); it then lies in a later wave and its items'
// stores wait until every item of the earlier waves has been read: a
// second counter counts items whose load has landed (the mbarrier wait
// shows it), and the waiting thread's acquire of that counter is followed
// by `fence.proxy.async` before its bulk store.  No row reads a block an
// earlier-waved row writes (that would be RAW), so loads never wait.  An
// item is counted before its CTA waits on any gate, so the items of wave 0
// always complete and the waits cannot deadlock: the call stays ONE
// launch.  The counters live in a per-(device, stream) scratch the wrapper
// allocates once; the last CTA to leave resets them.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "hopper.cuh"

namespace rc_block_move {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kRowCap = 320;          // rows carried in the launch parameters
constexpr int kStages = 4;            // chunk buffers of the copy ring
constexpr int kMinChunk = 4 * 1024;
constexpr int kMaxChunk = 32 * 1024;
constexpr int kItemsPerSm = 2;        // work items per SM the chunk aims at
constexpr int kMaxCtasPerSm = 8;
constexpr int kSmemPerSm = 227 * 1024;
constexpr int kMaxDevices = 64;

// return codes besides cudaError_t (which are >= 0)
constexpr int kRaw = -1;
constexpr int kWaw = -2;
constexpr int kNoRowBuffer = -3;

struct Params {
  char* dst;
  const char* src;
  unsigned long long* counters;  // [0] next item, [1] items read, [2] CTAs out
  const int* rows_dev;           // the rows in device memory, else `rows`
  long long dst_nblk, src_nblk, page_bytes;
  int layers, chunk, cpp, n_rows, word;
  int rows[kRowCap][3];          // src, dst, first row of its wave
};
static_assert(sizeof(Params) <= 4096, "launch parameters above 4 KB");

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------

struct Item {
  const char* src;
  char* dst;
  uint32_t bytes;
  unsigned long long gate;  // items of the earlier waves that must be read
};

template <bool kZero>
__device__ __forceinline__ Item locate(const Params& p, long long item) {
  const long long per_row = (long long)p.layers * p.cpp;
  const long long r = item / per_row;
  const long long rem = item - r * per_row;
  const long long layer = rem / p.cpp;
  const long long off = (rem - layer * p.cpp) * p.chunk;
  const long long left = p.page_bytes - off;
  const int* row = p.rows_dev ? p.rows_dev + 3 * r : p.rows[r];
  Item it;
  it.dst = p.dst + (layer * p.dst_nblk + row[1]) * p.page_bytes + off;
  it.src = kZero ? nullptr
                 : p.src + (layer * p.src_nblk + row[0]) * p.page_bytes + off;
  it.bytes = (uint32_t)(left < p.chunk ? left : p.chunk);
  it.gate = (unsigned long long)row[2] * per_row;
  return it;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned long long* p) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// a wait that outlasts kSpinLimit polls is a broken schedule: trap (the
// launch fails and the wrapper raises) rather than hang the card
constexpr long long kSpinLimit = 1LL << 26;

__device__ __forceinline__ void wait_count(const unsigned long long* count,
                                           unsigned long long gate) {
  for (long long spins = 0; ld_acquire(count) < gate; ++spins) {
    if (spins > kSpinLimit) __trap();
    __nanosleep(64);
  }
}

__device__ __forceinline__ void wait_gate(const Params& p,
                                          unsigned long long gate) {
  wait_count(p.counters + 1, gate);
}

// wait until the phase of parity `parity` of the mbarrier at `bar` completes
__device__ __forceinline__ void wait_loaded(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// K5, one thread: item k loads into stage k % kStages; the previous item's
// load is awaited, counted as read, gated and stored while item k's load
// is in flight
__device__ __forceinline__ void finish(const Params& p, const Item& it,
                                       long long k, uint32_t ring,
                                       const uint64_t* bars) {
  const int s = (int)(k % kStages);
  wait_loaded(smem_u32(&bars[s]), (uint32_t)((k / kStages) & 1));
  add_release(p.counters + 1);
  if (it.gate) {
    wait_gate(p, it.gate);
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  bulk_store(it.dst, ring + s * p.chunk, it.bytes);
}

__device__ __forceinline__ void copy_bulk(const Params& p, char* smem,
                                          uint64_t* bars, long long n_items) {
  const uint32_t ring = smem_u32(smem);
  for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  Item prev;
  long long k = 0;
  while (true) {
    const long long item = (long long)atomicAdd(p.counters, 1ULL);
    if (item >= n_items) break;
    const int s = (int)(k % kStages);
    // stores of items 0..k-2 are issued; item k - kStages's must be done
    // reading stage s
    if (k >= kStages) bulk_wait_read<kStages - 2>();
    const Item it = locate<false>(p, item);
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, (int)it.bytes);
    bulk_load(ring + s * p.chunk, it.src, it.bytes, bar);
    if (k > 0) finish(p, prev, k - 1, ring, bars);
    prev = it;
    ++k;
  }
  if (k > 0) finish(p, prev, k - 1, ring, bars);
  bulk_wait_all();
}

__device__ __forceinline__ void zero_bulk(const Params& p, char* smem,
                                          long long n_items) {
  for (int i = threadIdx.x * 16; i < p.chunk; i += kThreads * 16)
    *reinterpret_cast<int4*>(smem + i) = make_int4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint32_t tile = smem_u32(smem);
  while (true) {
    const long long item = (long long)atomicAdd(p.counters, 1ULL);
    if (item >= n_items) break;
    const Item it = locate<true>(p, item);
    bulk_store(it.dst, tile, it.bytes);
  }
  bulk_wait_all();
}

// what a word loop writes: a copy of `a`, zero bytes, or a AND / OR b, or
// NOT a, on the raw bits
enum WordOp { kOpCopy = 0, kOpZero = 1, kOpAnd = 2, kOpOr = 3, kOpNot = 4 };

template <int kOp, typename Lane>
__device__ __forceinline__ Lane lane_op(Lane a, Lane b) {
  if (kOp == kOpZero) return Lane(0);
  if (kOp == kOpAnd) return Lane(a & b);
  if (kOp == kOpOr) return Lane(a | b);
  if (kOp == kOpNot) return Lane(~a);
  return a;
}

template <int kOp>
__device__ __forceinline__ int4 word_op(int4 a, int4 b) {
  return make_int4(lane_op<kOp>(a.x, b.x), lane_op<kOp>(a.y, b.y),
                   lane_op<kOp>(a.z, b.z), lane_op<kOp>(a.w, b.w));
}

template <int kOp>
__device__ __forceinline__ int2 word_op(int2 a, int2 b) {
  return make_int2(lane_op<kOp>(a.x, b.x), lane_op<kOp>(a.y, b.y));
}

template <int kOp, typename Word>
__device__ __forceinline__ Word word_op(Word a, Word b) {
  return lane_op<kOp>(a, b);
}

template <typename Word, int kOp>
__device__ __forceinline__ void move_words(const char* a, const char* b,
                                           char* dst, long long nbytes) {
  const long long n = nbytes / (long long)sizeof(Word);
  const Word* sa = reinterpret_cast<const Word*>(a);
  const Word* sb = reinterpret_cast<const Word*>(b);
  Word* d = reinterpret_cast<Word*>(dst);
  for (long long base = threadIdx.x; base < n;
       base += (long long)kThreads * kUnroll) {
    Word va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) {
        va[u] = kOp == kOpZero ? Word() : sa[i];
        vb[u] = kOp == kOpAnd || kOp == kOpOr ? sb[i] : Word();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) d[i] = word_op<kOp>(va[u], vb[u]);
    }
  }
}

// kThreads threads move (or combine) `nbytes` in words of `word` bytes;
// each word is read before it is written, by the same thread, so `dst`
// may be `a` or `b`
template <int kOp>
__device__ __forceinline__ void move_bytes(int word, const char* a,
                                           const char* b, char* dst,
                                           long long nbytes) {
  switch (word) {
    case 16: move_words<int4, kOp>(a, b, dst, nbytes); break;
    case 8: move_words<int2, kOp>(a, b, dst, nbytes); break;
    case 4: move_words<int, kOp>(a, b, dst, nbytes); break;
    case 2: move_words<short, kOp>(a, b, dst, nbytes); break;
    default: move_words<char, kOp>(a, b, dst, nbytes); break;
  }
}

// pages that are not 16-byte aligned: every thread moves words; an item
// counts as read once all of it is moved
template <bool kZero>
__device__ __forceinline__ void move_loop(const Params& p, long long n_items,
                                          long long* s_item) {
  while (true) {
    if (threadIdx.x == 0) *s_item = (long long)atomicAdd(p.counters, 1ULL);
    __syncthreads();
    const long long item = *s_item;
    __syncthreads();
    if (item >= n_items) return;
    const Item it = locate<kZero>(p, item);
    if (it.gate && threadIdx.x == 0) wait_gate(p, it.gate);
    __syncthreads();
    move_bytes<kZero ? kOpZero : kOpCopy>(p.word, it.src, nullptr, it.dst,
                                          it.bytes);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      add_release(p.counters + 1);
    }
  }
}

// one thread per CTA, once every item the CTA took is done: the last CTA
// out resets the counters ([0] next item, [1] items read, [2] CTAs out) for
// the next call on this stream
__device__ __forceinline__ void leave(unsigned long long* counters) {
  __threadfence();
  if (atomicAdd(counters + 2, 1ULL) == gridDim.x - 1) {
    counters[0] = 0;
    counters[1] = 0;
    counters[2] = 0;
  }
}

template <bool kZero, bool kBulk>
__global__ void __launch_bounds__(kThreads)
    move_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ long long s_item;
  const long long n_items = (long long)p.n_rows * p.layers * p.cpp;
  if (!kBulk) {
    move_loop<kZero>(p, n_items, &s_item);
  } else if (kZero) {
    zero_bulk(p, smem, n_items);
  } else if (threadIdx.x == 0) {
    copy_bulk(p, smem, bars, n_items);
  }
  if (threadIdx.x == 0) leave(p.counters);
}

// ---------------------------------------------------------------------------
// host: schedule, parameters, launch
// ---------------------------------------------------------------------------

// what a call came to: out[0] live rows, [1] [2] the refused pair (src,
// dst), [3] work items, [4] grid, [5] chunk bytes, [6] waves, [7] 1 when
// the bulk path runs
constexpr int kOutWords = 8;

// per-thread host scratch, kept between calls (the entries release the
// GIL, so two Python threads may schedule at once)
struct Scratch {
  std::vector<int> writer, read;  // block id -> row / wave; -1, reset after
  std::vector<int> src, dst, wave, start;
  std::vector<int> rows;
};

static Scratch& scratch() {
  static thread_local Scratch t;
  return t;
}

template <typename Id>
static int schedule(const Id* ids, long long m, int width, long long n_src,
                    long long n_dst, bool same_pool, std::vector<int>& rows,
                    int* n_waves, long long* bad) {
  Scratch& t = scratch();
  std::vector<int>& src = t.src;
  std::vector<int>& dst = t.dst;
  src.clear();
  dst.clear();
  for (long long i = 0; i < m; ++i) {
    const long long d = (long long)ids[i * width + width - 1];
    // a negative id is above every block id as unsigned: one compare
    if ((unsigned long long)d >= (unsigned long long)n_dst) continue;
    long long s = width == 2 ? (long long)ids[i * width] : 0;
    s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
    src.push_back((int)s);
    dst.push_back((int)d);
  }
  const int n = (int)src.size();
  std::vector<int>& wave = t.wave;
  wave.assign(n, 0);
  int code = 0;
  int waves = n ? 1 : 0;
  if (width == 2 && n >= 2) {
    const size_t need = (size_t)(n_src > n_dst ? n_src : n_dst);
    if (t.writer.size() < need) {
      t.writer.resize(need, -1);
      t.read.resize(need, -1);
    }
    int* writer = t.writer.data();
    int* read = t.read.data();
    for (int i = 0; i < n && !code; ++i) {
      if (writer[dst[i]] >= 0) {
        code = kWaw;
        bad[0] = src[i];
        bad[1] = dst[i];
      } else {
        writer[dst[i]] = i;
      }
    }
    if (same_pool) {
      for (int i = 0; i < n && !code; ++i) {
        const int j = writer[src[i]];
        if (j >= 0 && j < i) {
          code = kRaw;
          bad[0] = src[i];
          bad[1] = dst[i];
        }
      }
      for (int i = 0; i < n && !code; ++i) {
        wave[i] = read[dst[i]] + 1;
        if (wave[i] >= waves) waves = wave[i] + 1;
        if (src[i] != dst[i] && read[src[i]] < wave[i]) read[src[i]] = wave[i];
      }
    }
    for (int i = 0; i < n; ++i) {
      writer[dst[i]] = -1;
      read[src[i]] = -1;
    }
  }
  if (code) return code;
  *n_waves = waves;
  rows.resize(3 * (size_t)n);
  if (waves <= 1) {                   // the common case: no sort
    for (int i = 0; i < n; ++i) {
      rows[3 * i] = src[i];
      rows[3 * i + 1] = dst[i];
      rows[3 * i + 2] = 0;
    }
    return 0;
  }
  // counting sort by wave (stable); each row carries its wave's first row
  std::vector<int>& start = t.start;
  start.assign(waves + 1, 0);
  for (int i = 0; i < n; ++i) ++start[wave[i] + 1];
  for (int w = 0; w < waves; ++w) start[w + 1] += start[w];
  for (int i = 0; i < n; ++i) {
    const int at = start[wave[i]]++;
    rows[3 * at] = src[i];
    rows[3 * at + 1] = dst[i];
  }
  // start[w] now ends wave w: its first row is start[w - 1] (0 for w = 0)
  for (int w = 0, first = 0; w < waves; first = start[w++])
    for (int at = first; at < start[w]; ++at) rows[3 * at + 2] = first;
  return 0;
}

static int word_bytes(long long page_bytes, const void* a, const void* b) {
  int word = 16;
  while (page_bytes % word || (uintptr_t)a % word || (uintptr_t)b % word)
    word /= 2;
  return word;
}

// chunk bytes, chunks per page, work items and grid of a call; the bulk
// path's CTA holds `buffers` chunks of shared memory
static void chunking(int n_rows, int layers, long long page_bytes, bool bulk,
                     int buffers, int sms, int* chunk, int* cpp,
                     long long* items, int* grid) {
  long long c;
  if (bulk) {
    const long long total = (long long)n_rows * layers * page_bytes;
    const long long slots = (long long)kItemsPerSm * sms;
    c = ((total + slots - 1) / slots + 15) / 16 * 16;
    c = c < kMinChunk ? kMinChunk : (c > kMaxChunk ? kMaxChunk : c);
    const long long pieces = (page_bytes + c - 1) / c;
    c = ((page_bytes + pieces - 1) / pieces + 15) / 16 * 16;
  } else {
    c = page_bytes < kMaxChunk ? page_bytes : kMaxChunk;
  }
  *chunk = (int)c;
  *cpp = (int)((page_bytes + c - 1) / c);
  *items = (long long)n_rows * layers * *cpp;
  int per_sm = kMaxCtasPerSm;
  if (bulk) {
    const long long smem = buffers * c + 1024;
    per_sm = (int)(kSmemPerSm / smem);
    per_sm = per_sm < 1 ? 1 : (per_sm > kMaxCtasPerSm ? kMaxCtasPerSm : per_sm);
  }
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(*items < cap ? (*items > 0 ? *items : 1) : cap);
}

template <typename Id>
static int plan(const Id* ids, long long m, int width, long long n_src,
                long long n_dst, bool same_pool, int layers,
                long long page_bytes, bool bulk, bool zero, int sms,
                std::vector<int>& rows, Params* p, long long* out) {
  for (int i = 0; i < kOutWords; ++i) out[i] = 0;
  int waves = 0;
  const int code = schedule(ids, m, width, n_src, n_dst, same_pool, rows,
                            &waves, out + 1);
  if (code) return code;
  const int n = (int)(rows.size() / 3);
  long long items;
  int grid;
  chunking(n, layers, page_bytes, bulk, zero ? 1 : kStages, sms, &p->chunk,
           &p->cpp, &items, &grid);
  p->n_rows = n;
  p->layers = layers;
  p->page_bytes = page_bytes;
  out[0] = n;
  out[3] = items;
  out[4] = grid;
  out[5] = p->chunk;
  out[6] = waves;
  out[7] = bulk;
  return 0;
}

// lets `kKernel` take `bytes` of dynamic shared memory (above 48 KB),
// once per device; returns a cudaError_t
template <auto kKernel>
static int allow_smem(int bytes) {
  static cudaError_t set[kMaxDevices];
  static bool done[kMaxDevices];
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    set[dev] = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done[dev] = true;
  }
  return (int)set[dev];
}

template <bool kZero, bool kBulk>
static int launch_kernel(const Params& p, int grid, void* stream) {
  const int smem = kBulk ? (kZero ? 1 : kStages) * p.chunk : 0;
  if (kBulk && !kZero) {
    const int err =
        allow_smem<&move_kernel<kZero, kBulk>>(kStages * kMaxChunk);
    if (err) return err;
  }
  // the bulk copy runs on one thread of each CTA: one warp is launched
  const int threads = kBulk && !kZero ? 32 : kThreads;
  move_kernel<kZero, kBulk><<<grid, threads, smem,
                              reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// one call: schedule, parameters, ONE launch (none without live rows)
template <bool kZero>
static int run(const void* ids, int id_bytes, long long m, void* dst,
               const void* src, long long dst_nblk, long long src_nblk,
               int layers, long long page_bytes, int same_pool,
               void* counters, void* rows_buf, long long rows_cap, int sms,
               void* stream, long long* out) {
  static thread_local Params params;
  Params& p = params;
  std::vector<int>& rows = scratch().rows;
  const int width = kZero ? 1 : 2;
  const int word = word_bytes(page_bytes, dst, kZero ? dst : src);
  const bool bulk = word == 16;
  const int code =
      id_bytes == 4
          ? plan(static_cast<const int32_t*>(ids), m, width, src_nblk,
                 dst_nblk, same_pool != 0, layers, page_bytes, bulk, kZero,
                 sms, rows, &p, out)
          : plan(static_cast<const int64_t*>(ids), m, width, src_nblk,
                 dst_nblk, same_pool != 0, layers, page_bytes, bulk, kZero,
                 sms, rows, &p, out);
  if (code || p.n_rows == 0) return code;
  p.dst = static_cast<char*>(dst);
  p.src = static_cast<const char*>(src);
  p.counters = static_cast<unsigned long long*>(counters);
  p.dst_nblk = dst_nblk;
  p.src_nblk = src_nblk;
  p.word = word;
  const size_t bytes = rows.size() * sizeof(int);
  if (p.n_rows <= kRowCap) {
    memcpy(p.rows, rows.data(), bytes);
    p.rows_dev = nullptr;
  } else {
    if (!rows_buf || rows_cap < p.n_rows) return kNoRowBuffer;
    // pageable source: the copy is staged before cudaMemcpyAsync returns
    const cudaError_t err =
        cudaMemcpyAsync(rows_buf, rows.data(), bytes, cudaMemcpyHostToDevice,
                        reinterpret_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    p.rows_dev = static_cast<const int*>(rows_buf);
  }
  const int grid = (int)out[4];
  return bulk ? launch_kernel<kZero, true>(p, grid, stream)
              : launch_kernel<kZero, false>(p, grid, stream);
}

}  // namespace rc_block_move
