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
// The design does nothing but stream bytes: 16-byte vector loads and stores,
// four vectors in flight per thread, dtype-blind (all pools of a flush share
// one block shape and dtype), and AND/OR/NOT on the 32-bit lanes of the same
// vectors.  The TPU's grid, VMEM tiling and semaphore ring are not carried
// over.
//
// Ordering.  A table holds no RAW and no WAW pair, and sources must see the
// pre-flush state.  Write-after-read pairs are allowed, adjacent or not, and
// rows here run concurrently.  The host therefore gives each row a wave
// (1 + the largest wave of any earlier row that reads its destination) and
// sorts the work items by wave.  CTAs take items in order from an atomic
// counter and an item of wave w starts only once every item of waves < w is
// done (a second counter).  An item that is waited on was taken earlier by a
// CTA that is already running, so the wait cannot deadlock, and the flush
// stays one launch of any grid size.  Most serve flushes are a single wave
// and never wait.
//
// Descriptor (int64 words, built by repro_torch/kernels/fused_dispatch.py):
//   [0] n_pools  [1] layers  [2] page_bytes  [3] n_rows  [4] chunk_bytes
//   [5] chunks_per_page  [6] n_waves  [7] total_blocks
//   then per pool: ptr, nblk, base, primary
//   then n_rows x (op, src, dst), sorted by wave
//   then n_waves + 1 item offsets (prefix sums)
//   then two zeroed counters: next item, items done.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ void locate(const long long* pools, int n_pools,
                                       long long gid, int* p,
                                       long long* local) {
  for (int i = n_pools - 1; i > 0; --i) {
    if (gid >= pools[4 * i + 2]) {
      *p = i;
      *local = gid - pools[4 * i + 2];
      return;
    }
  }
  *p = 0;
  *local = gid;
}

__device__ __forceinline__ char* page_ptr(const long long* pools, int p,
                                          long long layer, long long blk,
                                          long long page_bytes) {
  char* base = reinterpret_cast<char*>(pools[4 * p]);
  return base + (layer * pools[4 * p + 1] + blk) * page_bytes;
}

// mode 0: copy a -> dst; 1: zero dst; 2: and; 3: or; 4: not
__device__ __forceinline__ void stream_bytes(int mode, const int4* a,
                                             const int4* b, int4* dst,
                                             long long n16) {
  for (long long base = threadIdx.x; base < n16;
       base += (long long)kThreads * kUnroll) {
    int4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long i = base + (long long)u * kThreads;
      if (i < n16) {
        if (mode != 1) va[u] = a[i];
        if (mode == 2 || mode == 3) vb[u] = b[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long i = base + (long long)u * kThreads;
      if (i >= n16) continue;
      int4 r;
      if (mode == 0) {
        r = va[u];
      } else if (mode == 1) {
        r = make_int4(0, 0, 0, 0);
      } else if (mode == 2) {
        r = make_int4(va[u].x & vb[u].x, va[u].y & vb[u].y,
                      va[u].z & vb[u].z, va[u].w & vb[u].w);
      } else if (mode == 3) {
        r = make_int4(va[u].x | vb[u].x, va[u].y | vb[u].y,
                      va[u].z | vb[u].z, va[u].w | vb[u].w);
      } else {
        r = make_int4(~va[u].x, ~va[u].y, ~va[u].z, ~va[u].w);
      }
      dst[i] = r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
drain_kernel(const long long* desc, unsigned long long* counters) {
  __shared__ long long s_item;
  const int n_pools = (int)desc[0];
  const long long layers = desc[1];
  const long long page_bytes = desc[2];
  const long long n_rows = desc[3];
  const long long chunk_bytes = desc[4];
  const long long cpp = desc[5];
  const int n_waves = (int)desc[6];
  const long long total = desc[7];
  const long long* pools = desc + 8;
  const long long* rows = pools + 4 * n_pools;
  const long long* prefix = rows + 3 * n_rows;
  const long long n_items = prefix[n_waves];
  const long long per_row = layers * cpp;

  while (true) {
    if (threadIdx.x == 0) {
      s_item = (long long)atomicAdd(&counters[0], 1ULL);
    }
    __syncthreads();
    const long long item = s_item;
    __syncthreads();
    if (item >= n_items) return;
    int w = 0;
    while (prefix[w + 1] <= item) ++w;
    if (w > 0 && threadIdx.x == 0) {
      volatile unsigned long long* done = counters + 1;
      while ((long long)*done < prefix[w]) __nanosleep(128);
      __threadfence();
    }
    __syncthreads();

    const long long r = item / per_row;
    const long long rem = item - r * per_row;
    const long long layer = rem / cpp;
    const long long off = (rem - layer * cpp) * chunk_bytes;
    const long long nbytes =
        (page_bytes - off < chunk_bytes) ? page_bytes - off : chunk_bytes;
    const long long n16 = nbytes / 16;
    const int op = (int)rows[3 * r];
    const long long s = rows[3 * r + 1];
    const long long d = rows[3 * r + 2];

    if (op >= 0 && op <= 3) {
      // plain rows move the block in every primary pool
      for (int p = 0; p < n_pools; ++p) {
        if (!pools[4 * p + 3]) continue;
        int4* dst = reinterpret_cast<int4*>(
            page_ptr(pools, p, layer, d, page_bytes) + off);
        const int4* src =
            op == 3 ? nullptr
                    : reinterpret_cast<const int4*>(
                          page_ptr(pools, p, layer, s, page_bytes) + off);
        stream_bytes(op == 3 ? 1 : 0, src, nullptr, dst, n16);
      }
    } else if (op == 4) {
      int ps, pd;
      long long ls, ld;
      locate(pools, n_pools, s, &ps, &ls);
      locate(pools, n_pools, d, &pd, &ld);
      stream_bytes(0,
                   reinterpret_cast<const int4*>(
                       page_ptr(pools, ps, layer, ls, page_bytes) + off),
                   nullptr,
                   reinterpret_cast<int4*>(
                       page_ptr(pools, pd, layer, ld, page_bytes) + off),
                   n16);
    } else if (op >= 5 && op <= 7) {
      int pa, pb, pd;
      long long la, lb, ld;
      locate(pools, n_pools, s / total, &pa, &la);
      locate(pools, n_pools, s % total, &pb, &lb);
      locate(pools, n_pools, d, &pd, &ld);
      stream_bytes(op == 5 ? 2 : (op == 6 ? 3 : 4),
                   reinterpret_cast<const int4*>(
                       page_ptr(pools, pa, layer, la, page_bytes) + off),
                   reinterpret_cast<const int4*>(
                       page_ptr(pools, pb, layer, lb, page_bytes) + off),
                   reinterpret_cast<int4*>(
                       page_ptr(pools, pd, layer, ld, page_bytes) + off),
                   n16);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(&counters[1], 1ULL);
    }
  }
}

}  // namespace

extern "C" int rc_fused_drain(void* desc, void* counters, int grid,
                              void* stream) {
  drain_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const long long*>(desc),
      reinterpret_cast<unsigned long long*>(counters));
  return (int)cudaGetLastError();
}
