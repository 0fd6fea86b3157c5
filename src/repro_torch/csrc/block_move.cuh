// Shared body of K5 (csrc/fpm_copy.cu) and K6 (csrc/zero_init.cu): one
// launch moves (or zeroes) a list of blocks of one pool, in place.
//
// A block is `layers` pages of `page_bytes` each; page `layer` of block `b`
// lies at base + (layer * nblk + b) * page_bytes, so a layer-stacked pool
// (L, nblk, ...) moves L strided pages per block and a flat pool is the
// case layers == 1.  The kernel only streams bytes and is dtype-blind:
// `word_bytes` is 16 (int4 vectors) whenever the page size and both base
// pointers allow it, else the widest word that divides them.
//
// Ordering.  Sources must see the pre-call state, and a call may carry a
// write-after-read pair (row i reads block a, a later row writes a).  Rows
// run concurrently on the GPU, so the host gives each row a wave (1 + the
// largest wave of an earlier row reading its destination) and sorts the
// work items by wave.  CTAs take items in order from an atomic counter; an
// item of wave w starts once every item of the earlier waves is done (a
// second counter).  A waited-on item was taken earlier by a running CTA,
// so the wait cannot deadlock, and the call stays ONE launch.  Calls
// without a WAR pair are a single wave and never wait.
//
// Descriptor (int64 words, built by repro_torch/kernels/fpm_copy.py):
//   [0] dst base  [1] src base  [2] dst nblk  [3] src nblk  [4] layers
//   [5] page_bytes  [6] n_rows  [7] chunk_bytes  [8] chunks_per_page
//   [9] n_waves  [10] word_bytes
//   then n_rows x (src, dst), sorted by wave (src unused when zeroing)
//   then n_waves + 1 item offsets (prefix sums)
//   then two zeroed counters: next item, items done.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace rc_block_move {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename Word, bool kZero>
__device__ __forceinline__ void move_words(const char* src, char* dst,
                                           long long nbytes) {
  const long long n = nbytes / (long long)sizeof(Word);
  const Word* s = reinterpret_cast<const Word*>(src);
  Word* d = reinterpret_cast<Word*>(dst);
  for (long long base = threadIdx.x; base < n;
       base += (long long)kThreads * kUnroll) {
    Word v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) v[u] = kZero ? Word() : s[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) d[i] = v[u];
    }
  }
}

template <bool kZero>
__device__ __forceinline__ void move_bytes(int word, const char* src,
                                           char* dst, long long nbytes) {
  switch (word) {
    case 16: move_words<int4, kZero>(src, dst, nbytes); break;
    case 8: move_words<int2, kZero>(src, dst, nbytes); break;
    case 4: move_words<int, kZero>(src, dst, nbytes); break;
    case 2: move_words<short, kZero>(src, dst, nbytes); break;
    default: move_words<char, kZero>(src, dst, nbytes); break;
  }
}

template <bool kZero>
__global__ void __launch_bounds__(kThreads)
move_kernel(const long long* desc, unsigned long long* counters) {
  __shared__ long long s_item;
  char* dst_base = reinterpret_cast<char*>(desc[0]);
  const char* src_base = reinterpret_cast<const char*>(desc[1]);
  const long long dst_nblk = desc[2];
  const long long src_nblk = desc[3];
  const long long layers = desc[4];
  const long long page_bytes = desc[5];
  const long long n_rows = desc[6];
  const long long chunk_bytes = desc[7];
  const long long cpp = desc[8];
  const int n_waves = (int)desc[9];
  const int word = (int)desc[10];
  const long long* rows = desc + 11;
  const long long* prefix = rows + 2 * n_rows;
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
    const long long s = rows[2 * r];
    const long long d = rows[2 * r + 1];
    char* dst = dst_base + (layer * dst_nblk + d) * page_bytes + off;
    const char* src =
        kZero ? nullptr
              : src_base + (layer * src_nblk + s) * page_bytes + off;
    move_bytes<kZero>(word, src, dst, nbytes);

    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(&counters[1], 1ULL);
    }
  }
}

template <bool kZero>
int launch(void* desc, void* counters, int grid, void* stream) {
  move_kernel<kZero>
      <<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const long long*>(desc),
          reinterpret_cast<unsigned long long*>(counters));
  return (int)cudaGetLastError();
}

}  // namespace rc_block_move
