// K3: prefill attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attention.py
// (entered through `flash_attention_pallas`, `pallas_call` at :93):
// q (B, H, S, D) against k / v (B, KVH, S, D) with a causal mask plus a
// prefix-LM exception (key positions < prefix_len are visible to every
// query), GQA head h -> kv head h / group, online softmax in fp32, output in
// q's dtype (bf16 here).  A fully masked row gives 0 (acc / max(l, 1e-30)).
// Unlike the Pallas kernel, which asserts S % bq == 0, this one masks a
// ragged S: serve prompts have any length.
//
// Bound on this card: at prefill lengths the larger of the causal FLOPs over
// 989 TFLOP/s and the bytes over 3.35 TB/s.  This first version is simple
// and right rather than fast: one CTA of 256 threads per (64-row q tile,
// head, batch), for head dims D = 128 and 80 (a template parameter;
// zamba2's shared block uses 80), fp32 tiles of Q, K, V and P in shared memory (padded rows,
// no bank conflicts on the access patterns below), plain FMA for both
// products, kv tiles walked only up to the causal edge.  Each thread owns
// one query row and a quarter of its 64 scores and D output lanes; the
// four threads of a row sit in one warp, so the row max and sum are two
// shuffles and P is shared within the warp.  A tensor-core version
// (mma.sync or wgmma) is a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;  // padded row stride of P (floats)
constexpr float kNegInf = -1e30f;

// padded row strides of Q and K (floats); V is read along rows
template <int kD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (kD + 1) + kBK * (kD + 1) + kBK * kD + kBQ * kPS);
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int S, int H, int KVH,
             int causal, int prefix_len, float scale) {
  static_assert(kD % 4 == 0, "four threads split a row's D lanes");
  constexpr int kQS = kD + 1;
  constexpr int kKS = kD + 1;
  constexpr int kVS = kD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kQS;
  float* Vs = Ks + kBK * kKS;
  float* Ps = Vs + kBK * kVS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 2;     // query row within the tile
  const int sub = tid & 3;    // quarter of the row this thread owns
  const int row = q0 + r;

  const __nv_bfloat16* qb = q + ((long long)b * H + h) * S * kD;
  const __nv_bfloat16* kb = k + ((long long)b * KVH + kvh) * S * kD;
  const __nv_bfloat16* vb = v + ((long long)b * KVH + kvh) * S * kD;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int rr = i / kD, dd = i % kD;
    const int qr = q0 + rr;
    Qs[rr * kQS + dd] =
        qr < S ? __bfloat162float(qb[(long long)qr * kD + dd]) * scale : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kD / 4];
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    // causal edge: every later tile lies right of the diagonal too
    if (causal && k0 > q0 + kBQ - 1 && k0 >= prefix_len) break;
    __syncthreads();
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int jj = i / kD, dd = i % kD;
      const int kr = k0 + jj;
      const bool ok = kr < S;
      Ks[jj * kKS + dd] = ok ? __bfloat162float(kb[(long long)kr * kD + dd]) : 0.f;
      Vs[jj * kVS + dd] = ok ? __bfloat162float(vb[(long long)kr * kD + dd]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const int j = sub + 4 * c;
      const int col = k0 + j;
      const bool valid =
          col < S && (!causal || col <= row || col < prefix_len);
      float dot = 0.f;
      const float* qrow = Qs + r * kQS;
      const float* krow = Ks + j * kKS;
#pragma unroll 8
      for (int dd = 0; dd < kD; ++dd) dot += qrow[dd] * krow[dd];
      s[c] = valid ? dot : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = __expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const int j = sub + 4 * c;
      const float p = s[c] > 0.5f * kNegInf ? __expf(s[c] - m_new) : 0.f;
      Ps[r * kPS + j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) acc[i] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * kPS + j];
      const float* vrow = Vs + j * kVS + sub;
#pragma unroll
      for (int i = 0; i < kD / 4; ++i) acc[i] += p * vrow[4 * i];
    }
    __syncwarp();
  }

  if (row < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* ob = out + (((long long)b * H + h) * S + row) * kD + sub;
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) ob[4 * i] = __float2bfloat16(acc[i] * inv);
  }
}

template <int kD>
int launch(void* q, void* k, void* v, void* out, int B, int H, int KVH,
           int S, int causal, int prefix_len, float scale, void* stream) {
  constexpr size_t smem = smem_bytes<kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<kD><<<grid, kThreads, smem,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<__nv_bfloat16*>(out), S, H, KVH, causal, prefix_len,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim must be 128 or 80 (the wrapper checks; anything else is refused
// with cudaErrorInvalidValue)
extern "C" int rc_flash_attention(void* q, void* k, void* v, void* out,
                                  int B, int H, int KVH, int S, int head_dim,
                                  int causal, int prefix_len, float scale,
                                  void* stream) {
  if (head_dim == 128)
    return launch<128>(q, k, v, out, B, H, KVH, S, causal, prefix_len, scale,
                       stream);
  if (head_dim == 80)
    return launch<80>(q, k, v, out, B, H, KVH, S, causal, prefix_len, scale,
                      stream);
  return (int)cudaErrorInvalidValue;
}
