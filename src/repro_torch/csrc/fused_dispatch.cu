// K1: the fused command-table drain, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` in src/repro/kernels/fused_dispatch.py
// (entered through `fused_dispatch_pallas`, `pallas_call` at :406): one
// launch drains a whole flushed (m, 3) [opcode, src, dst] table in place over
// every pool.  Opcodes 0-2 copy a block in each primary pool, 3 writes zero
// bytes into it, 4 copies across pools by global id (base[p] + block), and
// 5-7 compute AND / OR / NOT on raw bits with src = a * total + b.
//
// Bound on this card: bytes.  A row moves one (layer, block) page of every
// pool it touches; the least time is (bytes read + bytes written) / 3.35 TB/s.
// The kernel only streams bytes, dtype-blind (the pools of a flush share one
// block shape and dtype).  The TPU's grid, VMEM tiling and semaphore ring
// are not carried over.
//
// Host (one C call per drain, no numpy, no device allocation): the entry
// reads the caller's raw table (int32 or int64), drops NOP rows (op < 0 or
// dst < 0), decodes each row against the pool records and expands it into
// "moves": a plain row (ops 0-3) into one move per primary pool, a
// cross-pool or bitwise row into one move between the pools its global ids
// name.  It gives each row a wave by the rule of
// repro_torch/kernels/fused_dispatch.py `wave_schedule` (0, or 1 + the
// largest wave of an EARLIER row reading a block this row writes; a key of
// every primary pool clashes with each primary pool's key of the same
// block, a staging key only with itself), refuses a RAW or WAW pair with the
// row's index, sorts the moves by wave (stable counting sort) and launches
// ONCE with the moves as launch parameters (`Params`, under 4 KB:
// `kMoveCap` moves).  A table with more moves copies them into a device
// buffer the caller keeps per (device, stream).  `plan_moves` and `chunking`
// in fused_dispatch.py state the plan in Python; `rc_fused_plan` returns it.
//
// Device.  Work items are (move, layer, chunk); the chunk follows the call
// (block_move.cuh `chunking`), and CTAs take items in order from a ticket
// counter.  With 16-byte aligned pages, thread 0 of each CTA keeps a ring of
// kStages chunk slots in shared memory: copy moves load one chunk with a
// bulk asynchronous copy (cp.async.bulk, global -> shared, completing on the
// slot's mbarrier) and store it back with a bulk store; AND / OR load two
// chunks into two consecutive slots and NOT one, then the CTA's threads
// combine the 32-bit lanes in shared memory, fence the generic-proxy writes
// (`fence.proxy.async.shared::cta`) and thread 0 issues the bulk store;
// zero moves issue bulk stores from one zeroed tile and read nothing.  One
// item's loads are in flight while the previous item is combined and
// stored (two items loading over six slots drained no faster on the
// card).  A slot is reloaded only once the store group that last read it
// is done reading (`cp.async.bulk.wait_group.read`), whatever mix of items
// the CTA drew.
// Pages that are not 16-byte aligned take block_move.cuh's 16/8/4/2/1-byte
// word loop over all threads, for every kind of move.
//
// Threads: 128.  A copy or zero item keeps one thread busy; a bitwise item
// needs the CTA to combine a chunk in shared memory (32 KiB is 16 vectors a
// thread at 128) and the word loop needs a CTA of threads.  Bitwise rows are
// few in the engine's tables, and one CTA fills an SM's shared memory (five
// 32 KiB buffers), so more threads would idle through the copies.
//
// Ordering.  Sources must see the pre-flush state.  A later wave's store
// waits until every item of the earlier waves has been READ: an item counts
// once its loads landed (a zero item at once), by a release add; the storing
// thread acquires the count and issues `fence.proxy.async.global` before its
// bulk store.  No row reads a block an earlier-waved row writes (that would
// be RAW), so loads never wait.  An item is counted before its CTA waits on
// any gate and tickets are taken in wave order, so wave 0 always drains and
// the waits cannot deadlock: the drain stays ONE launch of any grid.  A wait
// traps after a spin limit rather than hang the card.  The counters live in
// a per-(device, stream) scratch the wrapper allocates once; the last CTA
// out resets them (block_move.cuh `leave`).
#include "block_move.cuh"

namespace rc_fused {

namespace bm = rc_block_move;

constexpr int kThreads = bm::kThreads;
constexpr int kStages = 4;             // ring slots of one chunk each
constexpr int kBuffers = kStages + 1;  // the ring and the zero tile
// the finishing item and the loading one take at most two slots each
static_assert(kStages >= 4, "ring too small");
constexpr int kMaxPools = 16;
constexpr int kMoveCap = 188;          // moves carried in the launch parameters
constexpr long long kMaxPackBlocks = 46340;
static_assert(kThreads == 128, "the word loop of block_move.cuh");

// return codes besides cudaError_t (which are >= 0)
constexpr int kRaw = bm::kRaw;
constexpr int kWaw = bm::kWaw;
constexpr int kNoMoveBuffer = bm::kNoRowBuffer;
constexpr int kBadRow = -4;        // an opcode or id the contract does not know
constexpr int kTooManyPools = -5;

enum Kind { kCopy = 0, kZero = 1, kAnd = 2, kOr = 3, kNot = 4 };

struct Move {
  signed char kind, pd, pa, pb;  // kind; pools of dst, a, b (-1 unused)
  int dst, a, b;                 // blocks in those pools (-1 unused)
  int first;                     // the first move of this move's wave
};

struct Pool {
  char* ptr;
  long long nblk;
};

struct Params {
  unsigned long long* counters;  // [0] next item, [1] items read, [2] CTAs out
  const Move* moves_dev;         // the moves in device memory, else `moves`
  long long page_bytes;
  int layers, chunk, cpp, n_moves, word, n_pools;
  Pool pools[kMaxPools];
  Move moves[kMoveCap];
};
static_assert(sizeof(Move) == 20, "move layout");
static_assert(sizeof(Params) <= 4096, "launch parameters above 4 KB");

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------

struct Work {
  const char* a;
  const char* b;
  char* dst;
  uint32_t bytes;
  int kind;
  unsigned long long gate;  // items of the earlier waves that must be read
};

__device__ __forceinline__ char* page(const Params& p, int pool, int blk,
                                      long long layer) {
  return p.pools[pool].ptr + (layer * p.pools[pool].nblk + blk) * p.page_bytes;
}

__device__ __forceinline__ Work locate(const Params& p, long long item) {
  const long long per_move = (long long)p.layers * p.cpp;
  const long long m = item / per_move;
  const long long rem = item - m * per_move;
  const long long layer = rem / p.cpp;
  const long long off = (rem - layer * p.cpp) * p.chunk;
  const long long left = p.page_bytes - off;
  const Move mv = p.moves_dev ? p.moves_dev[m] : p.moves[m];
  Work w;
  w.kind = mv.kind;
  w.dst = page(p, mv.pd, mv.dst, layer) + off;
  w.a = mv.pa >= 0 ? page(p, mv.pa, mv.a, layer) + off : nullptr;
  w.b = mv.pb >= 0 ? page(p, mv.pb, mv.b, layer) + off : nullptr;
  w.bytes = (uint32_t)(left < p.chunk ? left : p.chunk);
  w.gate = (unsigned long long)mv.first * per_move;
  return w;
}

// ring slots an item loads into
__device__ __forceinline__ int slots_of(int kind) {
  return kind == kZero ? 0 : (kind == kAnd || kind == kOr ? 2 : 1);
}

// thread 0's account of the ring: ring position q uses slot q % kStages,
// and the slot's mbarrier completes one phase per use (parity (q / kStages)
// & 1); `reader[s]` is the store group (1-based, 0 none) that last read
// slot s, `committed` the groups issued so far
struct Ring {
  char* smem;      // the zero tile, then the kStages slots
  uint64_t* bars;
  int chunk;
  unsigned committed;
  unsigned reader[kStages];
};

__device__ __forceinline__ uint32_t slot_addr(const Ring& r, long long q) {
  return smem_u32(r.smem) + (uint32_t)((1 + q % kStages) * r.chunk);
}

__device__ __forceinline__ uint32_t bar_of(const Ring& r, long long q) {
  return smem_u32(&r.bars[q % kStages]);
}

__device__ __forceinline__ uint32_t parity(long long q) {
  return (uint32_t)((q / kStages) & 1);
}

// wait until store group `group` no longer reads shared memory: bulk groups
// complete in order, so at most `committed - group` newer ones may pend
__device__ __forceinline__ void wait_group_read(const Ring& r,
                                                unsigned group) {
  if (!group) return;
  switch (r.committed - group) {
    case 0: bm::bulk_wait_read<0>(); break;
    case 1: bm::bulk_wait_read<1>(); break;
    case 2: bm::bulk_wait_read<2>(); break;
    default: bm::bulk_wait_read<3>(); break;
  }
}

// thread 0: the loads of an item at ring position q
__device__ __forceinline__ void load(Ring& r, const Work& w, long long q) {
  for (int j = 0; j < slots_of(w.kind); ++j) {
    wait_group_read(r, r.reader[(q + j) % kStages]);
    const uint32_t bar = bar_of(r, q + j);
    mbar_expect_tx(bar, (int)w.bytes);
    bm::bulk_load(slot_addr(r, q + j), j ? w.b : w.a, w.bytes, bar);
  }
}

// the whole CTA: wait for an item's loads, count it as read, combine a
// bitwise item's chunks in shared memory, gate, and store (thread 0)
__device__ __forceinline__ void finish(const Params& p, Ring& r,
                                       const Work& w, long long q) {
  const int n = slots_of(w.kind);
  uint32_t src = slot_addr(r, q);
  if (w.kind == kZero) {
    if (threadIdx.x) return;
    src = smem_u32(r.smem);            // counted when it was taken
  } else if (w.kind == kCopy) {
    if (threadIdx.x) return;
    bm::wait_loaded(bar_of(r, q), parity(q));
    bm::add_release(p.counters + 1);
  } else {
    for (int j = 0; j < n; ++j) bm::wait_loaded(bar_of(r, q + j), parity(q + j));
    if (threadIdx.x == 0) bm::add_release(p.counters + 1);
    int4* x = reinterpret_cast<int4*>(r.smem + (1 + q % kStages) * r.chunk);
    const int4* y = reinterpret_cast<const int4*>(
        r.smem + (1 + (q + 1) % kStages) * r.chunk);
    for (uint32_t i = threadIdx.x; i < w.bytes / 16; i += kThreads) {
      x[i] = w.kind == kAnd  ? bm::word_op<bm::kOpAnd>(x[i], y[i])
             : w.kind == kOr ? bm::word_op<bm::kOpOr>(x[i], y[i])
                             : bm::word_op<bm::kOpNot>(x[i], x[i]);
    }
    // the generic-proxy writes before the bulk store reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x) return;
  }
  if (w.gate) {
    bm::wait_count(p.counters + 1, w.gate);
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  bm::bulk_store(w.dst, src, w.bytes);
  ++r.committed;
  for (int j = 0; j < n; ++j) r.reader[(q + j) % kStages] = r.committed;
}

__device__ __forceinline__ void drain_bulk(const Params& p, char* smem,
                                           uint64_t* bars, long long n_items,
                                           long long* s_item) {
  Ring r;
  r.smem = smem;
  r.bars = bars;
  r.chunk = p.chunk;
  r.committed = 0;
  for (int s = 0; s < kStages; ++s) r.reader[s] = 0;
  for (int i = threadIdx.x * 16; i < p.chunk; i += kThreads * 16)
    *reinterpret_cast<int4*>(smem + i) = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  Work prev;
  long long prev_q = 0, q = 0;
  for (long long k = 0;; ++k) {
    // two ticket words: the one written here was last read before the
    // previous iteration's barrier
    if (threadIdx.x == 0)
      s_item[k & 1] = (long long)atomicAdd(p.counters, 1ULL);
    __syncthreads();
    const long long item = s_item[k & 1];
    if (item >= n_items) {
      if (k > 0) finish(p, r, prev, prev_q);
      break;
    }
    const Work w = locate(p, item);
    if (threadIdx.x == 0) {
      if (w.kind == kZero)
        bm::add_release(p.counters + 1);   // reads nothing
      else
        load(r, w, q);
    }
    if (k > 0) finish(p, r, prev, prev_q);
    prev = w;
    prev_q = q;
    q += slots_of(w.kind);
  }
  if (threadIdx.x == 0) bm::bulk_wait_all();
}

// pages that are not 16-byte aligned: every thread moves words; an item
// counts as read once all of it is written
__device__ __forceinline__ void drain_words(const Params& p, long long n_items,
                                            long long* s_item) {
  for (long long k = 0;; ++k) {
    if (threadIdx.x == 0)
      s_item[k & 1] = (long long)atomicAdd(p.counters, 1ULL);
    __syncthreads();
    const long long item = s_item[k & 1];
    if (item >= n_items) return;
    const Work w = locate(p, item);
    if (w.gate && threadIdx.x == 0) bm::wait_count(p.counters + 1, w.gate);
    __syncthreads();
    switch (w.kind) {
      case kCopy:
        bm::move_bytes<bm::kOpCopy>(p.word, w.a, w.b, w.dst, w.bytes);
        break;
      case kZero:
        bm::move_bytes<bm::kOpZero>(p.word, w.a, w.b, w.dst, w.bytes);
        break;
      case kAnd:
        bm::move_bytes<bm::kOpAnd>(p.word, w.a, w.b, w.dst, w.bytes);
        break;
      case kOr:
        bm::move_bytes<bm::kOpOr>(p.word, w.a, w.b, w.dst, w.bytes);
        break;
      default:
        bm::move_bytes<bm::kOpNot>(p.word, w.a, w.b, w.dst, w.bytes);
        break;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      bm::add_release(p.counters + 1);
    }
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
    drain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ long long s_item[2];
  const long long n_items = (long long)p.n_moves * p.layers * p.cpp;
  if (kBulk)
    drain_bulk(p, smem, bars, n_items, s_item);
  else
    drain_words(p, n_items, s_item);
  if (threadIdx.x == 0) bm::leave(p.counters);
}

// ---------------------------------------------------------------------------
// host: decode, schedule, parameters, launch
// ---------------------------------------------------------------------------

// what a call came to: out[0] live rows, [1] moves, [2] work items, [3]
// grid, [4] chunk bytes, [5] waves, [6] 1 when the bulk path runs, [7] the
// refused row's index in the table (-1 none)
constexpr int kOutWords = 8;

// the global-id space of the pools: pool records are (ptr, nblk, primary)
struct Space {
  int n = 0;
  long long nblk[kMaxPools], base[kMaxPools];
  bool primary[kMaxPools];
  long long total = 0;
  long long plain_n = 0;  // plain rows' block ids lie below it
  long long all_n = 0;    // the largest pool

  explicit Space(const long long* recs, int n_pools) : n(n_pools) {
    long long least = -1;
    for (int i = 0; i < n; ++i) {
      nblk[i] = recs[3 * i + 1];
      primary[i] = recs[3 * i + 2] != 0;
      base[i] = total;
      total += nblk[i];
      if (nblk[i] > all_n) all_n = nblk[i];
      if (primary[i] && (least < 0 || nblk[i] < least)) least = nblk[i];
    }
    plain_n = least < 0 ? all_n : least;
  }

  bool locate(long long gid, int* p, long long* b) const {
    if (gid < 0 || gid >= total) return false;
    for (int i = n - 1; i >= 0; --i) {
      if (gid >= base[i]) {
        *p = i;
        *b = gid - base[i];
        return true;
      }
    }
    return false;
  }
};

// a hazard key: (pool, block), pool -1 standing for every primary pool;
// `idx` its slot in the hazard tables (the global id, or total + block)
struct Key {
  long long idx;
  int pool;
  long long blk;
};

static Key key_of(const Space& sp, int pool, long long blk) {
  return Key{pool < 0 ? sp.total + blk : sp.base[pool] + blk, pool, blk};
}

// every table slot whose key clashes with `k` (core/opcodes.py keys_clash)
template <typename F>
static void clashes(const Space& sp, const Key& k, F f) {
  f(k.idx);
  if (k.pool < 0) {
    for (int p = 0; p < sp.n; ++p)
      if (sp.primary[p]) f(sp.base[p] + k.blk);
  } else if (sp.primary[k.pool]) {
    f(sp.total + k.blk);
  }
}

// per-thread host scratch, kept between calls (the entries release the
// GIL, so two Python threads may schedule at once)
struct Scratch {
  std::vector<signed char> written;  // slot -> written; reset after a call
  std::vector<int> read;             // slot -> latest reader's wave, -1
  std::vector<long long> touched;
  std::vector<Move> moves, sorted;
  std::vector<int> wave, start, next;
};

static Scratch& scratch() {
  static thread_local Scratch t;
  return t;
}

static Move make_move(int kind, int pd, long long d, int pa, long long a,
                      int pb, long long b) {
  return Move{(signed char)kind, (signed char)pd, (signed char)pa,
              (signed char)pb, (int)d, (int)a, (int)b, 0};
}

// decode, hazards and waves of the live rows, in table order; the moves
// land in scratch().moves with their waves in scratch().wave
template <typename T>
static int schedule(const T* table, long long m, const Space& sp, int* live,
                    int* waves, long long* bad) {
  Scratch& t = scratch();
  const size_t need = (size_t)(sp.total + sp.all_n);
  if (t.written.size() < need) {
    t.written.resize(need, 0);
    t.read.resize(need, -1);
  }
  t.touched.clear();
  t.moves.clear();
  t.wave.clear();
  signed char* written = t.written.data();
  int* read = t.read.data();
  int code = 0;
  *live = 0;
  *waves = 0;
  for (long long i = 0; i < m; ++i) {
    const long long op = (long long)table[3 * i];
    const long long s = (long long)table[3 * i + 1];
    const long long d = (long long)table[3 * i + 2];
    if (op < 0 || d < 0) continue;
    ++*live;
    Key rd[2], wr;
    int n_rd = 0;
    Move mv{};
    const bool plain = op <= 3;
    if (plain) {
      if (d >= sp.plain_n || (op != 3 && (s < 0 || s >= sp.plain_n))) {
        code = kBadRow;
      } else {
        if (op != 3) rd[n_rd++] = key_of(sp, -1, s);
        wr = key_of(sp, -1, d);
      }
    } else if (op == 4) {
      int ps, pd;
      long long ls, ld;
      if (!sp.locate(s, &ps, &ls) || !sp.locate(d, &pd, &ld)) {
        code = kBadRow;
      } else {
        rd[n_rd++] = key_of(sp, ps, ls);
        wr = key_of(sp, pd, ld);
        mv = make_move(kCopy, pd, ld, ps, ls, -1, -1);
      }
    } else if (op <= 7) {
      int pa, pb, pd;
      long long la, lb, ld;
      // 64-bit: a packed id lies below MAX_PACK_BLOCKS^2
      if (sp.total > kMaxPackBlocks || s < 0 || s >= sp.total * sp.total ||
          !sp.locate(s / sp.total, &pa, &la) ||
          !sp.locate(s % sp.total, &pb, &lb) || !sp.locate(d, &pd, &ld)) {
        code = kBadRow;
      } else {
        rd[n_rd++] = key_of(sp, pa, la);
        if (s / sp.total != s % sp.total) rd[n_rd++] = key_of(sp, pb, lb);
        wr = key_of(sp, pd, ld);
        mv = op == 7 ? make_move(kNot, pd, ld, pa, la, -1, -1)
                     : make_move(op == 5 ? kAnd : kOr, pd, ld, pa, la, pb, lb);
      }
    } else {
      code = kBadRow;
    }
    bool hit = false;
    for (int j = 0; j < n_rd && !code; ++j)
      clashes(sp, rd[j], [&](long long x) { hit |= written[x] != 0; });
    if (!code && hit) code = kRaw;
    if (!code) clashes(sp, wr, [&](long long x) { hit |= written[x] != 0; });
    if (!code && hit) code = kWaw;
    if (code) {
      *bad = i;
      break;
    }
    int wave = 0;
    clashes(sp, wr, [&](long long x) {
      if (read[x] + 1 > wave) wave = read[x] + 1;
    });
    for (int j = 0; j < n_rd; ++j) {
      if (rd[j].idx == wr.idx || read[rd[j].idx] >= wave) continue;
      read[rd[j].idx] = wave;
      t.touched.push_back(rd[j].idx);
    }
    written[wr.idx] = 1;
    t.touched.push_back(wr.idx);
    if (wave + 1 > *waves) *waves = wave + 1;
    if (plain) {
      for (int p = 0; p < sp.n; ++p) {
        if (!sp.primary[p]) continue;
        t.moves.push_back(op == 3 ? make_move(kZero, p, d, -1, -1, -1, -1)
                                  : make_move(kCopy, p, d, p, s, -1, -1));
        t.wave.push_back(wave);
      }
    } else {
      t.moves.push_back(mv);
      t.wave.push_back(wave);
    }
  }
  for (long long x : t.touched) {
    written[x] = 0;
    read[x] = -1;
  }
  return code;
}

// the moves sorted by wave (stable), each with its wave's first move, into
// scratch().sorted
static void sort_moves(int waves) {
  Scratch& t = scratch();
  const int n = (int)t.moves.size();
  t.sorted.resize(n);
  if (waves <= 1) {                  // the common case: no sort
    for (int i = 0; i < n; ++i) {
      t.sorted[i] = t.moves[i];
      t.sorted[i].first = 0;
    }
    return;
  }
  std::vector<int>& start = t.start;  // wave -> its first move
  std::vector<int>& next = t.next;    // wave -> its next free place
  start.assign(waves + 1, 0);
  for (int i = 0; i < n; ++i) ++start[t.wave[i] + 1];
  for (int w = 0; w < waves; ++w) start[w + 1] += start[w];
  next = start;
  for (int i = 0; i < n; ++i) {
    const int w = t.wave[i];
    Move& mv = t.sorted[next[w]++];
    mv = t.moves[i];
    mv.first = start[w];
  }
}

// the plan of one call into scratch().sorted, `p` (chunking, moves) and
// `out`; returns 0, kRaw, kWaw, kBadRow or kTooManyPools
template <typename T>
static int plan(const T* table, long long m, const long long* recs,
                int n_pools, int layers, long long page_bytes, bool bulk,
                int sms, int max_grid, Params* p, long long* out) {
  for (int i = 0; i < kOutWords; ++i) out[i] = 0;
  out[7] = -1;
  if (n_pools < 1 || n_pools > kMaxPools) return kTooManyPools;
  const Space sp(recs, n_pools);
  int live = 0, waves = 0;
  const int code = schedule(table, m, sp, &live, &waves, out + 7);
  if (code) return code;
  sort_moves(waves);
  const int n = (int)scratch().sorted.size();
  long long items;
  int grid;
  bm::chunking(n, layers, page_bytes, bulk, kBuffers, sms, &p->chunk,
               &p->cpp, &items, &grid);
  if (max_grid > 0 && grid > max_grid) grid = max_grid;
  p->n_moves = n;
  p->layers = layers;
  p->page_bytes = page_bytes;
  out[0] = live;
  out[1] = n;
  out[2] = items;
  out[3] = grid;
  out[4] = p->chunk;
  out[5] = waves;
  out[6] = bulk;
  return 0;
}

// the widest access (16, 8, ... 1 bytes) dividing the page and every base
static int word_bytes(long long page_bytes, const long long* recs,
                      int n_pools) {
  int word = 16;
  for (int i = 0; i < n_pools; ++i)
    while (page_bytes % word || (unsigned long long)recs[3 * i] % word)
      word /= 2;
  return word;
}

template <bool kBulk>
static int launch(const Params& p, int grid, void* stream) {
  int smem = 0;
  if (kBulk) {
    smem = kBuffers * p.chunk;
    const int err = bm::allow_smem<&drain_kernel<true>>(kBuffers *
                                                        bm::kMaxChunk);
    if (err) return err;
  }
  drain_kernel<kBulk><<<grid, kThreads, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rc_fused

// one drain of K1: `table` (m, 3) int32 or int64 (`id_bytes`), `pools`
// (n_pools, 3) int64 records (ptr, nblk, primary), pages of `page_bytes`
// in `layers` layers; `moves_buf` (room for `moves_cap` moves) takes the
// moves above the parameters' room; `max_grid` > 0 caps the grid.  Returns
// 0, a cudaError_t or kRaw / kWaw / kNoMoveBuffer / kBadRow /
// kTooManyPools; `out` as `plan` fills it.  No launch without moves.
extern "C" int rc_fused_drain(const void* table, int id_bytes, long long m,
                              const long long* pools, int n_pools, int layers,
                              long long page_bytes, void* counters,
                              void* moves_buf, long long moves_cap, int sms,
                              int max_grid, void* stream, long long* out) {
  using namespace rc_fused;
  static thread_local Params params;
  Params& p = params;
  const int word = word_bytes(
      page_bytes, pools, n_pools < kMaxPools ? n_pools : kMaxPools);
  const bool bulk = word == 16;
  const int code =
      id_bytes == 4
          ? plan(static_cast<const int32_t*>(table), m, pools, n_pools,
                 layers, page_bytes, bulk, sms, max_grid, &p, out)
          : plan(static_cast<const int64_t*>(table), m, pools, n_pools,
                 layers, page_bytes, bulk, sms, max_grid, &p, out);
  if (code || p.n_moves == 0) return code;
  p.counters = static_cast<unsigned long long*>(counters);
  p.word = word;
  p.n_pools = n_pools;
  for (int i = 0; i < n_pools; ++i)
    p.pools[i] = Pool{reinterpret_cast<char*>(pools[3 * i]), pools[3 * i + 1]};
  const std::vector<Move>& moves = scratch().sorted;
  const size_t bytes = moves.size() * sizeof(Move);
  if (p.n_moves <= kMoveCap) {
    memcpy(p.moves, moves.data(), bytes);
    p.moves_dev = nullptr;
  } else {
    if (!moves_buf || moves_cap < p.n_moves) return kNoMoveBuffer;
    // pageable source: the copy is staged before cudaMemcpyAsync returns
    const cudaError_t err =
        cudaMemcpyAsync(moves_buf, moves.data(), bytes,
                        cudaMemcpyHostToDevice,
                        reinterpret_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    p.moves_dev = static_cast<const Move*>(moves_buf);
  }
  const int grid = (int)out[3];
  return bulk ? launch<true>(p, grid, stream) : launch<false>(p, grid, stream);
}

// the plan alone, for checks: the moves as the kernel gets them into
// `moves_out` ((n, 8) int32 rows kind, pd, dst, pa, a, pb, b, first; room
// for `moves_cap`) and `out` as `rc_fused_drain` fills it
extern "C" int rc_fused_plan(const void* table, int id_bytes, long long m,
                             const long long* pools, int n_pools, int layers,
                             long long page_bytes, int bulk, int sms,
                             int max_grid, int* moves_out,
                             long long moves_cap, long long* out) {
  using namespace rc_fused;
  Params* p = new Params;
  const int code =
      id_bytes == 4
          ? plan(static_cast<const int32_t*>(table), m, pools, n_pools,
                 layers, page_bytes, bulk != 0, sms, max_grid, p, out)
          : plan(static_cast<const int64_t*>(table), m, pools, n_pools,
                 layers, page_bytes, bulk != 0, sms, max_grid, p, out);
  delete p;
  if (code) return code;
  const std::vector<Move>& moves = scratch().sorted;
  if ((long long)moves.size() > moves_cap) return kNoMoveBuffer;
  for (size_t i = 0; i < moves.size(); ++i) {
    const Move& mv = moves[i];
    const int row[8] = {mv.kind, mv.pd, mv.dst, mv.pa, mv.a, mv.pb, mv.b,
                        mv.first};
    memcpy(moves_out + 8 * i, row, sizeof(row));
  }
  return 0;
}

// the design constants the Python side states (kernels/fused_dispatch.py)
extern "C" void rc_fused_constants(long long* out) {
  using namespace rc_fused;
  const long long c[] = {kMoveCap, kMaxPools, kStages, bm::kMinChunk,
                         bm::kMaxChunk, bm::kItemsPerSm, bm::kMaxCtasPerSm,
                         bm::kSmemPerSm, kThreads, (long long)sizeof(Params),
                         (long long)sizeof(Move)};
  for (int i = 0; i < 11; ++i) out[i] = c[i];
}
