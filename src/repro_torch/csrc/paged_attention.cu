// K2: paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_attn_kernel` in
// src/repro/kernels/paged_attention.py (entered through
// `paged_attention_slab_pallas`, `pallas_call` at :98): one new-token query
// per sequence attends over a pool slab (nblk, page, KVH, D).  Block `blk` is
// visible to sequence b when share_mask[blk, b] > 0 and
// base[blk] + slot < seq_lens[b]; GQA maps query head h to kv head h / group;
// scores are scaled by D^-0.5.  Returns the unnormalised acc (B, H, D) and
// the softmax partials l, m (B, H), all fp32.  A sequence with no visible
// position returns m = -1e30, l = 0, acc = 0.  CoW-shared blocks count for
// every reader (all-pairs mode).
//
// Bound on this card: bytes.  Every K/V slot below some reader's length is
// read once; the least time is those bytes / 3.35 TB/s.  A decode call
// reads a few MB, so what decides its time is how many loads are in flight
// at once, not the arithmetic.  Design:
//
// * Pages split over a thread-block cluster.  Grid (kSplits, KVH, B) with
//   cluster dims (kSplits, 1, 1): the kSplits = 8 CTAs (the portable cluster
//   size) of one (kv head, sequence) split that sequence's visible blocks,
//   in block order, into contiguous ranges: split s takes positions
//   [s n / 8, (s + 1) n / 8) of the n visible blocks (a split may get none).
//   Every CTA redoes the compaction (a ballot over share_mask's column, 512
//   bytes at the serving shape) rather than receive it from rank 0: it costs
//   one round of loads and saves a cluster barrier.
// * Inside a CTA (128 threads; 256 at D = 256), the pages of its range go
//   through two shared-memory stages with cp.async (16-byte copies, only the
//   page's valid slots): page t + 1 is in flight while page t is scored.
//   Rows are padded by 16 bytes, so the 16-byte reads of neighbouring slots
//   fall in distinct banks.
// * Scores: thread t takes slot t % 64 and part t / 64 of the head dim
//   (halves; quarters at D = 256), for all `group` query heads of its kv
//   head at once (the query, pre-scaled, sits in shared memory as fp32), so
//   each K load serves the whole group.  One warp per query head then sums
//   the parts in order and runs the online softmax in fp32.
// * P V from shared memory: thread t owns output pair t % (D / 2) of every
//   head of the group, over a quarter, a third or half of the page's slots
//   (a quarter at D = 64, where 128 threads give each of the 32 pairs four;
//   half at D = 256, where the CTA's 256 threads give every pair two
//   threads); the slot subsets are summed once, after the last page.
// * Merge through distributed shared memory: each CTA leaves its (acc, l,
//   m) in its own shared memory; after a cluster barrier rank 0 reads all
//   eight and merges them with the reference's `lse_combine` rule
//   (src/repro/models/attention.py:156-162) without its final division:
//   m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m).  An
//   empty split holds m = -1e30, l = 0, acc = 0: its factor underflows to 0
//   beside a real maximum, and when every split is empty the factors are 1
//   and the sums 0, so no NaN and the empty-sequence result is exact.  A
//   second cluster barrier keeps every CTA's shared memory alive until rank
//   0 has read it.  One launch per call.
//
// Blocks no sequence reads are never touched.  The TPU's block_chunk tiling
// and its all-sequence score tile are not carried over.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplits = 8;          // CTAs per cluster: the portable maximum
constexpr int kMaxGroup = 8;
constexpr int kMaxPage = 64;        // slots of a page (the serving page)
constexpr float kNegInf = -1e30f;

// the CTA's threads and shared-memory layout for head dim kD (offsets in
// bytes): 128 threads score a slot in two halves of the head dim and give
// each output pair two to four slot subsets up to D = 128 (four at D = 64);
// 256 threads, in quarters and with two subsets, at D = 256
template <int kD>
struct Layout {
  static constexpr int kThreads = kD > 128 ? 256 : 128;
  static constexpr int kParts = kThreads / kMaxPage;      // of a slot's score
  static constexpr int kRow = kD + 8;                     // padded bf16 row
  static constexpr int kTile = kMaxPage * kRow;           // bf16 of a page
  static constexpr int kK = 0;                            // K, 2 stages
  static constexpr int kV = kK + 2 * kTile * 2;           // V, 2 stages
  static constexpr int kQ = kV + 2 * kTile * 2;           // group x D fp32
  static constexpr int kPart = kQ + kMaxGroup * kD * 4;   // parts' scores
  static constexpr int kP = kPart + kParts * kMaxGroup * kMaxPage * 4;
  static constexpr int kAcc = kP + kMaxGroup * kMaxPage * 4;
  static constexpr int kML = kAcc + kMaxGroup * kD * 4;   // m, then l
  static constexpr int kList = kML + 2 * kMaxGroup * 4;   // nblk ints, bits
  static size_t bytes(int nblk) {   // + one bit word a warp per round
    return (size_t)kList + 4 * (size_t)nblk +
           (kThreads / 8) * (size_t)((nblk + kThreads - 1) / kThreads);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int kD>
__global__ void __cluster_dims__(kSplits, 1, 1)
    __launch_bounds__(Layout<kD>::kThreads)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int8_t* __restrict__ mask,
                  const int* __restrict__ base,
                  const int* __restrict__ lens, float* __restrict__ acc_out,
                  float* __restrict__ l_out, float* __restrict__ m_out,
                  int nblk, int page, int kvh_n, int batch, int group,
                  float scale) {
  using Lay = Layout<kD>;
  constexpr int kThreads = Lay::kThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kParts = Lay::kParts;
  constexpr int kRow = Lay::kRow;
  constexpr int kTile = Lay::kTile;
  constexpr int kChunks = kD / 8;            // 16-byte chunks of a row
  constexpr int kPairs = kD / 2;             // output pairs of a head
  constexpr int kSub = kThreads / kPairs;    // slot subsets of P V
  static_assert(kD % 16 == 0 && kSub >= 2 && kChunks % kParts == 0 &&
                    kThreads == kParts * kMaxPage,
                "kParts threads score a slot, two or more own an output "
                "pair");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kK);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kV);
  float* q_s = reinterpret_cast<float*>(smem + Lay::kQ);
  float* part = reinterpret_cast<float*>(smem + Lay::kPart);
  float* p_s = reinterpret_cast<float*>(smem + Lay::kP);
  float* acc_s = reinterpret_cast<float*>(smem + Lay::kAcc);
  float* ml_s = reinterpret_cast<float*>(smem + Lay::kML);
  int* list = reinterpret_cast<int*>(smem + Lay::kList);
  unsigned* bits = reinterpret_cast<unsigned*>(list + nblk);
  __shared__ float s_corr[kMaxGroup];
  __shared__ int s_nvalid[2];
  __shared__ int s_n;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int heads = kvh_n * group;
  const int len = lens[b];

  // the visible blocks of sequence b as a bitmask, then in block order
  for (int c0 = 0; c0 < nblk; c0 += kThreads) {
    const int blk = c0 + tid;
    bool vis = false;
    if (blk < nblk && mask[(long long)blk * batch + b] > 0)
      vis = base[blk] < len;
    const unsigned bal = __ballot_sync(0xffffffffu, vis);
    if (lane == 0) bits[(c0 >> 5) + warp] = bal;
  }
  // the group's query heads, pre-scaled
  const __nv_bfloat16* qb = q + ((long long)b * heads + kvh * group) * kD;
  for (int e = tid; e < group * kD; e += kThreads)
    q_s[e] = __bfloat162float(qb[e]) * scale;
  if (tid < kMaxGroup) {
    ml_s[tid] = kNegInf;
    ml_s[kMaxGroup + tid] = 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (nblk + 31) >> 5;
    int off = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      unsigned word = w < nw ? bits[w] : 0u;
      const int cnt = __popc(word);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int pos = off + incl - cnt;
      while (word) {
        list[pos++] = (w << 5) + __ffs(word) - 1;
        word &= word - 1u;
      }
      off += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_n = off;
  }
  __syncthreads();
  const int n_vis = s_n;
  const int lo = split * n_vis / kSplits;
  const int n_mine = (split + 1) * n_vis / kSplits - lo;

  const long long slot_stride = (long long)kvh_n * kD;
  // copy the valid slots of visible block t of the range into `stage`
  auto load_page = [&](int t, int stage) {
    const int blk = list[lo + t];
    const int nvalid = min(page, len - base[blk]);
    if (tid == 0) s_nvalid[stage] = nvalid;
    const long long blk0 = ((long long)blk * page * kvh_n + kvh) * kD;
    __nv_bfloat16* dk = sk + stage * kTile;
    __nv_bfloat16* dv = sv + stage * kTile;
    for (int e = tid; e < nvalid * kChunks; e += kThreads) {
      const int slot = e / kChunks;
      const int c = (e - slot * kChunks) * 8;
      const long long g = blk0 + slot * slot_stride + c;
      cp_async16(dk + slot * kRow + c, k + g);
      cp_async16(dv + slot * kRow + c, v + g);
    }
  };

  float acc[kMaxGroup][2];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int pr = tid % kPairs;
  const int sub = tid / kPairs;

  if (n_mine > 0) load_page(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_mine; ++t) {
    const int st = t & 1;
    if (t + 1 < n_mine) load_page(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();                 // page t is in shared memory
    const int nvalid = s_nvalid[st];

    // partial scores over one part of the head dim
    {
      const int j = tid & (kMaxPage - 1);
      const int slice = tid / kMaxPage;   // the part of the head dim
      float sc[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) sc[g] = 0.f;
      if (j < nvalid) {
        const __nv_bfloat16* kr = sk + st * kTile + j * kRow;
#pragma unroll
        for (int c = 0; c < kChunks / kParts; ++c) {
          const int d0 = (slice * (kChunks / kParts) + c) * 8;
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          float kf[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h2[i]);
            kf[2 * i] = f.x;
            kf[2 * i + 1] = f.y;
          }
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) {
              const float4 qa =
                  *reinterpret_cast<const float4*>(q_s + g * kD + d0);
              const float4 qc =
                  *reinterpret_cast<const float4*>(q_s + g * kD + d0 + 4);
              sc[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] +
                       qa.w * kf[3] + qc.x * kf[4] + qc.y * kf[5] +
                       qc.z * kf[6] + qc.w * kf[7];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group)
          part[(slice * kMaxGroup + g) * kMaxPage + j] = sc[g];
    }
    __syncthreads();

    // online softmax, one warp per query head of the group
    for (int g = warp; g < group; g += kWarps) {
      const float* pg = part + g * kMaxPage;
      float t0 = pg[lane], t1 = pg[lane + 32];
#pragma unroll
      for (int i = 1; i < kParts; ++i) {     // the parts, in order
        t0 += pg[i * kMaxGroup * kMaxPage + lane];
        t1 += pg[i * kMaxGroup * kMaxPage + lane + 32];
      }
      const bool ok0 = lane < nvalid, ok1 = lane + 32 < nvalid;
      const float s0 = ok0 ? t0 : kNegInf;
      const float s1 = ok1 ? t1 : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ml_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = ok0 ? __expf(s0 - m_new) : 0.f;
      const float e1 = ok1 ? __expf(s1 - m_new) : 0.f;
      p_s[g * kMaxPage + lane] = e0;
      p_s[g * kMaxPage + lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        s_corr[g] = corr;
        ml_s[kMaxGroup + g] = ml_s[kMaxGroup + g] * corr + sum;
        ml_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[pair] += sum over this thread's slots of p * V[slot, pair]
    if (sub < kSub) {
      float pv[kMaxGroup][2];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) pv[g][0] = pv[g][1] = 0.f;
      const __nv_bfloat16* vc = sv + st * kTile + 2 * pr;
      for (int j = sub; j < nvalid; j += kSub) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vc + j * kRow));
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float p = p_s[g * kMaxPage + j];
            pv[g][0] += p * vv.x;
            pv[g][1] += p * vv.y;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          acc[g][0] = acc[g][0] * s_corr[g] + pv[g][0];
          acc[g][1] = acc[g][1] * s_corr[g] + pv[g][1];
        }
      }
    }
    __syncthreads();                 // stage st is free again
  }

  // sum the slot subsets into acc_s (the K stages are free: scratch)
  float* red = reinterpret_cast<float*>(smem + Lay::kK);
  if (sub < kSub) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float* r = red + (sub * kMaxGroup + g) * kD + 2 * pr;
        r[0] = acc[g][0];
        r[1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < group * kD; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) a += red[s * kMaxGroup * kD + e];
    acc_s[e] = a;
  }

  // merge the kSplits partials on rank 0 through distributed shared memory
  cluster.sync();
  if (split == 0) {
    float* fac = part;                 // [kSplits][kMaxGroup] merge factors
    const long long bh0 = (long long)b * heads + kvh * group;
    if (tid < group) {
      float mr[kSplits];
      float M = kNegInf;
#pragma unroll
      for (int r = 0; r < kSplits; ++r) {
        mr[r] = cluster.map_shared_rank(ml_s, r)[tid];
        M = fmaxf(M, mr[r]);
      }
      float L = 0.f;
#pragma unroll
      for (int r = 0; r < kSplits; ++r) {
        const float f = expf(mr[r] - M);
        fac[r * kMaxGroup + tid] = f;
        L += f * cluster.map_shared_rank(ml_s, r)[kMaxGroup + tid];
      }
      m_out[bh0 + tid] = M;
      l_out[bh0 + tid] = L;
    }
    __syncthreads();
    for (int e = tid; e < group * kD; e += kThreads) {
      const int g = e / kD;
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < kSplits; ++r)
        a += fac[r * kMaxGroup + g] * cluster.map_shared_rank(acc_s, r)[e];
      acc_out[bh0 * kD + e] = a;
    }
  }
  // every CTA's shared memory stays alive until rank 0 has read it
  cluster.sync();
}

template <int kD>
int launch(void* q, void* k, void* v, void* mask, void* base, void* lens,
           void* acc, void* l, void* m, int nblk, int page, int kvh,
           int batch, int group, float scale, void* stream) {
  using Lay = Layout<kD>;
  const size_t smem = Lay::bytes(nblk);
  static size_t allowed = 48 * 1024;   // raised once per larger slab
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  dim3 grid(kSplits, kvh, batch);
  paged_attn_kernel<kD><<<grid, Lay::kThreads, smem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<const int8_t*>(mask),
      reinterpret_cast<const int*>(base), reinterpret_cast<const int*>(lens),
      reinterpret_cast<float*>(acc), reinterpret_cast<float*>(l),
      reinterpret_cast<float*>(m), nblk, page, kvh, batch, group, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a call takes for `nblk` slab blocks (the wrapper checks it
// against the card's 227 KB).
extern "C" long long rc_paged_attention_smem(int head_dim, int nblk) {
  if (head_dim == 64) return (long long)Layout<64>::bytes(nblk);
  if (head_dim == 128) return (long long)Layout<128>::bytes(nblk);
  if (head_dim == 80) return (long long)Layout<80>::bytes(nblk);
  if (head_dim == 256) return (long long)Layout<256>::bytes(nblk);
  return -1;
}

// The design's constants, which the wrapper states again for the CPU
// emulation of the split (chip_smoke.py holds the two copies equal).
extern "C" int rc_paged_attention_splits() { return kSplits; }
extern "C" int rc_paged_attention_max_page() { return kMaxPage; }
extern "C" int rc_paged_attention_max_group() { return kMaxGroup; }

// head_dim must be 64, 80, 128 or 256 and page <= 64, group <= 8 (the wrapper
// checks; another head dim is refused with cudaErrorInvalidValue)
extern "C" int rc_paged_attention(void* q, void* k, void* v, void* mask,
                                  void* base, void* lens, void* acc, void* l,
                                  void* m, int nblk, int page, int kvh,
                                  int batch, int group, int head_dim,
                                  float scale, void* stream) {
  if (head_dim == 128)
    return launch<128>(q, k, v, mask, base, lens, acc, l, m, nblk, page, kvh,
                       batch, group, scale, stream);
  if (head_dim == 80)
    return launch<80>(q, k, v, mask, base, lens, acc, l, m, nblk, page, kvh,
                      batch, group, scale, stream);
  if (head_dim == 256)
    return launch<256>(q, k, v, mask, base, lens, acc, l, m, nblk, page, kvh,
                       batch, group, scale, stream);
  if (head_dim == 64)
    return launch<64>(q, k, v, mask, base, lens, acc, l, m, nblk, page, kvh,
                      batch, group, scale, stream);
  return (int)cudaErrorInvalidValue;
}
