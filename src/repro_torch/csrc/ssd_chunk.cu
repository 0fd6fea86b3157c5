// K4: the Mamba2 SSD intra-chunk term, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_intra_kernel` in src/repro/kernels/ssd_chunk.py
// (entered through `ssd_intra_chunk_pallas`, `pallas_call` at :47), whose
// oracle is `_ssd_intra_chunk_jnp` in src/repro/models/mamba2.py.  For every
// chunk row b and head h:
//
//   y[b, i, h, :] = sum_{j <= i} (C[b, i] . B[b, j]) * exp(cum[b, i, h] -
//                   cum[b, j, h]) * dt[b, j, h] * x[b, j, h, :]
//
// with x (Bc, Q, H, P), dt and cum (Bc, Q, H) fp32, B and C (Bc, Q, N),
// x / B / C in bf16 or fp32, and y (Bc, Q, H, P) fp32.  The caller folds the
// chunks of a prefill into Bc, so one launch covers a whole Mamba2 layer.
//
// Bound on this card: at the model's shapes (Q = 256, N = 64-128, P = 64)
// the kernel body's 2 Q^2 (N + P) FLOPs per chunk and head over 989 TFLOP/s
// and the bytes (inputs once, the fp32 output once) over 3.35 TB/s are of
// the same order; the byte bound is the larger.  This first version is
// simple and right rather than fast: fp32 FMA on shared-memory tiles, no
// tensor cores.
//
// Design.  The Pallas kernel materialises the whole (Q, Q) fp32 decay tile
// (256 KiB at Q = 256), more than a CTA's 227 KB of shared memory.  Here the
// work is tiled like attention without a softmax: one CTA of 256 threads per
// (64-row i-tile, head, chunk row) keeps C_i (N x 64, transposed) and walks
// the 64-row j-tiles up to the diagonal.  Each step loads B_j (transposed),
// x_j, cum_j and dt_j, forms the 64 x 64 scores C_i B_j^T in fp32 (a 4 x 4
// register tile per thread), turns them into W = scores * exp(cum_i - cum_j)
// * dt_j where i >= j (selected: for i < j the exponent is positive and may
// overflow, so exp is never evaluated there), stores W^T, and adds W x_j into
// the 64 x P accumulator (again 4 x 4 per thread).  Tiles above the diagonal
// are skipped.  A ragged Q (a prompt shorter than the chunk) is masked: rows
// past Q load as zero and are not stored.  B and C do not depend on h, so
// the scores are recomputed per head; sharing them is a later optimisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // rows of an i-tile and of a j-tile
constexpr int kP = 64;          // head dim P (columns of x and y)
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTS = kT + 4;     // padded stride of the transposed tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y, int Q,
                 int H, int N) {
  extern __shared__ float smem[];
  float* Ct = smem;                   // N x kTS: C_i transposed
  float* Bt = Ct + N * kTS;           // N x kTS: B_j transposed
  float* Xs = Bt + N * kTS;           // kT x kP: x_j
  float* Wt = Xs + kT * kP;           // kT x kTS: W transposed (j, i)
  float* cum_i = Wt + kT * kTS;       // kT
  float* cum_j = cum_i + kT;          // kT
  float* dt_j = cum_j + kT;           // kT

  const int it = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;            // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;            // columns 4 tx .. 4 tx + 3
  const int i0 = it * kT;

  const T* Cb = Cm + (long long)b * Q * N;
  const T* Bb = Bm + (long long)b * Q * N;
  const float* dtb = dt + (long long)b * Q * H + h;
  const float* cumb = cum + (long long)b * Q * H + h;
  const T* xb = x + ((long long)b * Q * H + h) * kP;

  // C_i, transposed; consecutive threads read consecutive n (coalesced)
  for (int e = tid; e < kT * N; e += kThreads) {
    const int r = e / N, n = e % N;
    const int gi = i0 + r;
    Ct[n * kTS + r] = gi < Q ? to_f(Cb[(long long)gi * N + n]) : 0.f;
  }
  if (tid < kT) {
    const int gi = i0 + tid;
    cum_i[tid] = gi < Q ? cumb[(long long)gi * H] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();   // the previous step is done with Bt, Xs, Wt
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e % N;
      const int gj = j0 + r;
      Bt[n * kTS + r] = gj < Q ? to_f(Bb[(long long)gj * N + n]) : 0.f;
    }
    for (int e = tid; e < kT * kP; e += kThreads) {
      const int r = e / kP, p = e % kP;
      const int gj = j0 + r;
      Xs[r * kP + p] =
          gj < Q ? to_f(xb[(long long)gj * H * kP + p]) : 0.f;
    }
    if (tid < kT) {
      const int gj = j0 + tid;
      cum_j[tid] = gj < Q ? cumb[(long long)gj * H] : 0.f;
      dt_j[tid] = gj < Q ? dtb[(long long)gj * H] : 0.f;
    }
    __syncthreads();

    // scores of rows 4 ty.., columns 4 tx.. of this (i, j) tile pair
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(Ct + n * kTS + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(Bt + n * kTS + 4 * tx);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += ca[a] * ba[c];
    }
    // W = scores * exp(cum_i - cum_j) * dt_j where i >= j, else 0; the
    // exponent is <= 0 wherever it is evaluated
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int li = 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = 4 * tx + c;
        float w = 0.f;
        if (j0 + lj <= i0 + li && i0 + li < Q)
          w = s[a][c] * expf(cum_i[li] - cum_j[lj]) * dt_j[lj];
        Wt[lj * kTS + li] = w;
      }
    }
    __syncthreads();

    // acc += W x_j over this j-tile
    for (int j = 0; j < kT; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(Wt + j * kTS + 4 * ty);
      const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kP + 4 * tx);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += wa[a] * xa[c];
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + 4 * ty + a;
    if (gi < Q) {
      float4* yp = reinterpret_cast<float4*>(
          y + (((long long)b * Q + gi) * H + h) * kP + 4 * tx);
      *yp = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

size_t smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)2 * N * kTS + kT * kP + kT * kTS + 3 * kT);
}

template <typename T>
int launch(const void* x, const void* dt, const void* cum, const void* Bm,
           const void* Cm, void* y, int batch, int Q, int H, int N,
           void* stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Q + kT - 1) / kT, H, batch);
  ssd_intra_kernel<T><<<grid, kThreads, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const float*>(dt),
      reinterpret_cast<const float*>(cum), reinterpret_cast<const T*>(Bm),
      reinterpret_cast<const T*>(Cm), reinterpret_cast<float*>(y), Q, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 inputs x / B / C, 1 = bf16.  P is fixed at 64.
extern "C" int rc_ssd_intra_chunk(void* x, void* dt, void* cum, void* Bm,
                                  void* Cm, void* y, int batch, int Q, int H,
                                  int N, int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, cum, Bm, Cm, y, batch, Q, H, N,
                                 stream);
  return launch<float>(x, dt, cum, Bm, Cm, y, batch, Q, H, N, stream);
}
