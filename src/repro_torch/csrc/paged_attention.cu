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
// Bound on this card: bytes.  Every live K/V byte is read once; the least
// time is the live KV bytes / 3.35 TB/s.  Design: one CTA of 128 threads per
// (kv head, sequence), for head dims D = 128 and 80 (a template parameter;
// zamba2's shared block uses 80).  At D = 80 lanes 20-31 of a scoring warp
// and threads 80-127 of the output pass hold no element and only take part
// in the block's barriers.  The CTA first compacts, in block order, the blocks
// its sequence can see (a ballot over share_mask), then walks only those:
// each warp scores page slots with 8-byte coalesced K loads and a warp
// reduction for the `group` query heads of its kv head, the online softmax
// runs in fp32 in shared memory, and each of the first D threads accumulates
// one of the D output lanes from coalesced V loads.  Blocks no sequence reads are never
// touched.  The TPU's block_chunk tiling and its all-sequence score tile are
// not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

template <int kD>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int8_t* __restrict__ mask,
                  const int* __restrict__ base,
                  const int* __restrict__ lens, float* __restrict__ acc_out,
                  float* __restrict__ l_out, float* __restrict__ m_out,
                  int nblk, int page, int kvh_n, int batch, int group,
                  float scale) {
  extern __shared__ float smem[];
  float* s_score = smem;                                  // group * page
  int* s_list = reinterpret_cast<int*>(smem + group * page);  // nblk
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_corr[kMaxGroup];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_n;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int heads = kvh_n * group;
  const int len = lens[b];

  if (tid < group) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();

  // ordered compaction of the blocks visible to sequence b
  for (int c0 = 0; c0 < nblk; c0 += kThreads) {
    const int blk = c0 + tid;
    const bool vis = blk < nblk && mask[(long long)blk * batch + b] > 0 &&
                     base[blk] < len;
    const unsigned bal = __ballot_sync(0xffffffffu, vis);
    if (lane == 0) s_wcount[warp] = __popc(bal);
    __syncthreads();
    int off = s_n;
    for (int w = 0; w < warp; ++w) off += s_wcount[w];
    if (vis) s_list[off + __popc(bal & ((1u << lane) - 1u))] = blk;
    __syncthreads();
    if (tid == 0) {
      int n = s_n;
      for (int w = 0; w < kWarps; ++w) n += s_wcount[w];
      s_n = n;
    }
    __syncthreads();
  }
  const int n_vis = s_n;

  static_assert(kD % 4 == 0 && kD <= 4 * 32 && kD <= kThreads,
                "one warp scores a slot, one thread owns an output lane");
  // this lane's four elements of each query head of the group, pre-scaled
  // (lanes past D / 4 hold zeros)
  const bool lane_has_d = lane * 4 < kD;
  const bool thread_has_d = tid < kD;
  float qr[kMaxGroup][4];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[g][i] = 0.f;
    if (g < group && lane_has_d) {
      const __nv_bfloat16* qp =
          q + ((long long)b * heads + kvh * group + g) * kD + lane * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[g][i] = __bfloat162float(qp[i]) * scale;
    }
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const long long slot_stride = (long long)kvh_n * kD;
  for (int t = 0; t < n_vis; ++t) {
    const int blk = s_list[t];
    const int bb = base[blk];
    const int nvalid = min(page, len - bb);
    const long long blk0 = ((long long)blk * page * kvh_n + kvh) * kD;

    for (int slot = warp; slot < nvalid; slot += kWarps) {
      uint2 raw = make_uint2(0u, 0u);
      if (lane_has_d)
        raw = *reinterpret_cast<const uint2*>(
            k + blk0 + slot * slot_stride + lane * 4);
      const __nv_bfloat162* kv2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 k01 = __bfloat1622float2(kv2[0]);
      const float2 k23 = __bfloat1622float2(kv2[1]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float dot = qr[g][0] * k01.x + qr[g][1] * k01.y +
                      qr[g][2] * k23.x + qr[g][3] * k23.y;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (lane == 0) s_score[g * page + slot] = dot;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head of the group
    for (int g = warp; g < group; g += kWarps) {
      float* sg = s_score + g * page;
      float mx = kNegInf;
      for (int j = lane; j < nvalid; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nvalid; j += 32) {
        const float p = __expf(sg[j] - m_new);
        sg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // acc[d = tid] += sum_slot p * V[slot, d]
    float pv[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) pv[g] = 0.f;
    const __nv_bfloat16* vp = v + blk0 + tid;
    for (int slot = 0; thread_has_d && slot < nvalid; ++slot) {
      const float vv = __bfloat162float(vp[slot * slot_stride]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) pv[g] += s_score[g * page + slot] * vv;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] = acc[g] * s_corr[g] + pv[g];
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const long long bh = (long long)b * heads + kvh * group + g;
      if (thread_has_d) acc_out[bh * kD + tid] = acc[g];
      if (tid == 0) {
        l_out[bh] = s_l[g];
        m_out[bh] = s_m[g];
      }
    }
  }
}

template <int kD>
int launch(void* q, void* k, void* v, void* mask, void* base, void* lens,
           void* acc, void* l, void* m, int nblk, int page, int kvh,
           int batch, int group, float scale, void* stream) {
  const size_t smem = sizeof(float) * (size_t)group * page +
                      sizeof(int) * (size_t)nblk;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kvh, batch);
  paged_attn_kernel<kD><<<grid, kThreads, smem,
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

// head_dim must be 128 or 80 (the wrapper checks; anything else is refused
// with cudaErrorInvalidValue)
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
  return (int)cudaErrorInvalidValue;
}
