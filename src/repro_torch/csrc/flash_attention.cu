// K3: prefill attention, hand-written for Hopper (sm_90a) with tensor cores.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attention.py
// (entered through `flash_attention_pallas`, `pallas_call` at :93):
// q (B, H, Sq, D) against k / v (B, KVH, Skv, D), non-causal (every key
// below Skv is visible) or with a causal mask (key column <= query row +
// q_offset, both counted from 0: q_offset is the position of q's first row,
// 0 for a whole prompt, a block's first row for a block of query rows) plus
// a prefix-LM exception (key positions < prefix_len are visible to every
// query), GQA head h -> kv head h / group, the scale D^-0.5
// applied to the fp32 scores after the product, online softmax in fp32,
// output in bf16.  A fully masked row gives 0.  Sq and Skv differ for an
// encoder-decoder's cross-attention (text queries over S_src frames; one
// query at a decode step).  Unlike the Pallas kernel, which asserts
// Sq % bq == 0 and Sk % bk == 0, this one takes ragged lengths: serve
// prompts have any length.
//
// Bound on this card: at prefill lengths the causal FLOPs over 989 TFLOP/s
// and the bytes over 3.35 TB/s are both a few microseconds, so the design
// keeps the tensor cores fed and every operand out of registers it does not
// need:
//
// * One CTA per (64-row q tile, head, batch): one consumer warpgroup (warps
//   0-3) and one producer warp (warp 4).  The q tiles launch longest first
//   (reverse blockIdx.x), so the causal rows that walk the most kv tiles
//   start before the short ones.  A non-causal CTA visits every kv tile
//   below Skv whatever its q tile; a causal one the tiles up to its last
//   row (or the prefix), never past Skv.
// * At D = 256 (paligemma-3b) one warpgroup's O accumulator would be 128
//   fp32 registers a thread on top of the scores and P's parts, so the head
//   dim is split over two consumer warpgroups (warps 0-7; the producer is
//   warp 8): both compute the same S = Q K^T over all 256 columns and run
//   the same softmax, and each keeps O for its own 128 columns (64
//   registers, as at D = 128).  A tile is then four 64-column boxes
//   (32 KiB): Q plus two K / V stages take 160 KiB, one CTA per SM.
// * The producer loads the Q tile once and the K / V tiles through a
//   two-stage ring with TMA (cp.async.bulk.tensor, 4-D maps over (D, S,
//   heads, batch) built on the host from the caller's strides, so q / k / v
//   may be transposed views of a (B, S, H, D) layout).  Each tile is two
//   boxes of 64 rows x 64 bf16 columns in the 128-byte swizzle (one box at
//   D = 64, seamless-m4t-medium's head dim); at D = 80 the second box's
//   columns 80-127 lie past the tensor's edge and arrive as zeros, as do
//   the rows past Sq or Skv, so the ragged tail costs no branch in the
//   loads.  A short key length (an encoder of 14 frames) fills most of its
//   one tile with zeros: the mask, not the fill, keeps those columns out of
//   the softmax.  Per stage, one mbarrier for K and one for V (Q K^T starts while
//   V is in flight) and an `empty` one hand the tiles between the roles.
// * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major), D / 16 steps (five at D = 80: the arithmetic is not padded).
//   The scores are scaled in fp32 after the product (folded with log2(e)
//   into exp2f), masked only on diagonal tiles and the tile at the ragged
//   kv edge, and tiles right of the diagonal are never loaded unless they
//   lie in the prefix.
// * O += P V is wgmma m64nDk16 (n = 64, 80 or 128) with P in registers (wgmma's A-register
//   layout is its accumulator layout) and V read from shared memory with the
//   transpose bit (MN-major).  The reference multiplies fp32 weights; one
//   bf16 P would be off by up to 2^-8 of each weight, enough to flip the
//   output's bf16 rounding by one ulp (1.6e-2 at |x| in [2, 4)) on many
//   elements.  So P goes in as two bf16 parts, hi = bf16(P) and lo =
//   bf16(P - hi), each through its own wgmma into the same fp32 sums: P is
//   then off by at most 2^-16 of each weight.
// * The output is written straight from the accumulators to the caller's
//   (B, Sq, H, D) buffer (strided), rows >= Sq masked.
//
// The mbarrier, TMA, descriptor and wgmma helpers live in hopper.cuh, which
// K4 (ssd_chunk.cu) shares.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;                      // q rows per CTA (one warpgroup)
constexpr int kBK = 64;                      // kv rows per tile
constexpr int kStages = 2;

// the CTA's shape for head dim kD: one consumer warpgroup up to D = 128,
// two above it, each owning kDW columns of O
template <int kD>
struct Shape {
  static constexpr int kGroups = kD > 128 ? 2 : 1;     // consumer warpgroups
  static constexpr int kDW = kD / kGroups;             // O columns of one
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;     // + the producer warp
  static constexpr int kBoxes = kD > 128 ? 4 : kD > 64 ? 2 : 1;  // of 64 cols
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // a 64-row tile
  static constexpr int kSmemBytes = kTileBytes * (1 + 2 * kStages) + 1024;
  static constexpr int kMinBlocks = kGroups == 1 ? 2 : 1;
};

struct Params {
  __nv_bfloat16* out;
  long long osb, osh, oss;   // output strides (elements) of b, h, s
  int Sq, Skv, H, KVH, causal, prefix_len, q_offset;
  float scale_log2;          // D^-0.5 * log2(e)
};

// O (kN columns) += P V, P from registers
template <int kN>
__device__ __forceinline__ void pv_mma(float (&o)[kN / 2],
                                       const uint32_t (&a)[4], uint64_t v) {
  if constexpr (kN == 128) {
    wgmma_rs_n128(o, a, v);
  } else if constexpr (kN == 80) {
    wgmma_rs_n80(o, a, v);
  } else {
    wgmma_rs_n64(o, a, v);
  }
}

template <int kD>
__global__ void __launch_bounds__(Shape<kD>::kThreads, Shape<kD>::kMinBlocks)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using Sh = Shape<kD>;
  constexpr int kConsumers = Sh::kConsumers;
  constexpr int kTileBytes = Sh::kTileBytes;
  constexpr int kDW = Sh::kDW;
  static_assert(kD % 16 == 0 && (kDW == 128 || kDW == 80 || kDW == 64) &&
                    kD <= Sh::kBoxes * kBoxCols,
                "head dim: a warpgroup's O columns are one wgmma's n");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kTileBytes;
  const uint32_t sv = sk + kStages * kTileBytes;
  // one barrier per stage for K and one for V, so that Q K^T starts while
  // V is still in flight; `empty` hands a stage back to the producer
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);                 // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[1 + kStages]);       // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + 2 * kStages]);

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int q0 = qt * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int Skv = p.Skv;
  // kv tiles to visit: all of them, or (causal) a prefix of them up to the
  // causal edge of the tile's last row or the prefix, whichever lies further
  int n_kv = (Skv + kBK - 1) / kBK;
  if (p.causal) {
    const int edge = max((q0 + p.q_offset + kBQ - 1) / kBK + 1,
                         (p.prefix_len + kBK - 1) / kBK);
    n_kv = min(n_kv, edge);
  }
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, kTileBytes);
#pragma unroll
      for (int c = 0; c < Sh::kBoxes; ++c)
        tma_load(sq + c * kBoxBytes, &tq, bar_q, c * kBoxCols, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t k_dst = sk + s * kTileBytes;
        const uint32_t v_dst = sv + s * kTileBytes;
        const int k0 = t * kBK;
        mbar_expect_tx(bar_k + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < Sh::kBoxes; ++c)
          tma_load(k_dst + c * kBoxBytes, &tk, bar_k + 8 * s, c * kBoxCols,
                   k0, kvh, b);
        mbar_expect_tx(bar_v + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < Sh::kBoxes; ++c)
          tma_load(v_dst + c * kBoxBytes, &tv, bar_v + 8 * s, c * kBoxCols,
                   k0, kvh, b);
      }
    }
    return;
  }

  // consumer warpgroup g owns O columns [g kDW, (g + 1) kDW); its warp w
  // owns q rows 16w..16w+15 of the tile; a thread holds rows r0 and r0 + 8,
  // columns 8j + 2 (lane % 4) + {0, 1} of the scores and of its O columns
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const float sl2 = p.scale_log2;
  // this warpgroup's V columns start kDW / 64 boxes into a tile
  const uint32_t v_cols = wg * (kDW / kBoxCols) * kBoxBytes;

  float o[kDW / 2];
#pragma unroll
  for (int i = 0; i < kDW / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of the raw scores
  float l0 = 0.f, l1 = 0.f;               // this thread's part of the sums

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    mbar_wait(bar_k + 8 * s, phase);
    const uint32_t k_tile = sk + s * kTileBytes;
    const uint32_t v_tile = sv + s * kTileBytes;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(sc, kmajor_desc(sq, kk), kmajor_desc(k_tile, kk),
                   kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = t * kBK;
    const bool edge = k0 + kBK > Skv;
    const bool diag = p.causal && k0 + kBK - 1 > q0 + p.q_offset &&
                      k0 + kBK > p.prefix_len;
    if (edge || diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + cq + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          const bool ok = col < Skv &&
                          (!p.causal || col <= row + p.q_offset ||
                           col < p.prefix_len);
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with no visible column yet keeps max -inf: offset 0 then gives
    // exp2(-inf) = 0 for every masked score instead of NaN
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float corr0 = exp2f(m0 * sl2 - b0);
    const float corr1 = exp2f(m1 * sl2 - b1);
    m0 = mx0;
    m1 = mx1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2f(fmaf(sc[4 * j], sl2, -b0));
      sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], sl2, -b0));
      sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], sl2, -b1));
      sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], sl2, -b1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < kDW / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // P as the A operand of O += P V, in hi and lo parts: k16 step kk holds
    // score columns 16kk..16kk+15, the accumulator blocks 2kk and 2kk + 1
    uint32_t a[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], a[kk][i],
                   a_lo[kk][i]);
      }
    }
    mbar_wait(bar_v + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pv_mma<kDW>(o, a[kk], vmajor_desc(v_tile + v_cols, kk));
      pv_mma<kDW>(o, a_lo[kk], vmajor_desc(v_tile + v_cols, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);   // this stage's K / V are read
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = p.out + (long long)b * p.osb + (long long)h * p.osh +
                      wg * kDW;
#pragma unroll
  for (int j = 0; j < kDW / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < p.Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * p.oss + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (r1 < p.Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * p.oss + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int kD>
int launch(void* q, void* k, void* v, const long long* st, int B, int H,
           int KVH, cudaStream_t stream, const Params& p) {
  using Sh = Shape<kD>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sh::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, kD, p.Sq, H, B, st[2], st[1], st[0]);
  if (!err) err = make_map(&tk, k, kD, p.Skv, KVH, B, st[5], st[4], st[3]);
  if (!err) err = make_map(&tv, v, kD, p.Skv, KVH, B, st[8], st[7], st[6]);
  if (err) return err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<kD><<<grid, Sh::kThreads, Sh::kSmemBytes, stream>>>(tq, tk,
                                                                   tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k / v (B, KVH, Skv, D) bf16 at any strides whose last
// one is 1 and whose others are multiples of 8 elements: `strides` holds
// (b, h, s) of q, k, v and the output, 12 values in elements.  Sq, Skv >= 1.
// head_dim must be 64, 80, 128 or 256 (anything else gives
// cudaErrorInvalidValue); a tensor-map failure gives 10000 + its CUresult.
extern "C" int rc_flash_attention(void* q, void* k, void* v, void* out,
                                  const long long* strides, int B, int H,
                                  int KVH, int Sq, int Skv, int head_dim,
                                  int causal, int prefix_len, int q_offset,
                                  float scale, void* stream) {
  Params p;
  p.out = reinterpret_cast<__nv_bfloat16*>(out);
  p.osb = strides[9];
  p.osh = strides[10];
  p.oss = strides[11];
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.KVH = KVH;
  p.causal = causal;
  p.prefix_len = prefix_len;
  p.q_offset = q_offset;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch<128>(q, k, v, strides, B, H, KVH, st, p);
  if (head_dim == 80) return launch<80>(q, k, v, strides, B, H, KVH, st, p);
  if (head_dim == 256) return launch<256>(q, k, v, strides, B, H, KVH, st, p);
  if (head_dim == 64) return launch<64>(q, k, v, strides, B, H, KVH, st, p);
  return (int)cudaErrorInvalidValue;
}
