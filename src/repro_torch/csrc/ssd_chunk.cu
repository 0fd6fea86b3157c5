// K4: the Mamba2 SSD intra-chunk term, hand-written for Hopper (sm_90a) with
// tensor cores.
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
// x / B / C in bf16 or fp32, and y (Bc, Q, H, P) fp32; P = 64, N <= 256,
// Q <= 256.  The caller folds the chunks of a prefill into Bc, so one launch
// covers a whole Mamba2 layer.
//
// Bound on this card: at the models' shapes (Q = 256, N = 64-128, P = 64)
// the bytes (inputs once, the fp32 output once) over 3.35 TB/s exceed the
// 2 Q^2 (N + P) FLOPs per chunk and head over 989 TFLOP/s.
//
// bf16 inputs (every model call) run on the tensor cores, on K3's skeleton
// (flash_attention.cu; the mbarrier, TMA, descriptor and wgmma helpers are
// hopper.cuh's).  It is K3 without the softmax:
//
// * One CTA per (64-row i-tile, pair of heads, chunk row), the i-tiles
//   longest first: one consumer warpgroup and one producer warp.  The heads
//   per CTA come from the register budget: each head's 64 x 64 fp32 sum
//   takes 32 registers a thread, beside the scores (32) and one head's W
//   operand (48).  Two CTAs of five warps share an SM only at <= 168
//   registers a thread; two heads fit that (ptxas spills 72 bytes) and the
//   two CTAs hide each other's latency.  Four heads (232 registers, one CTA
//   per SM) were slower on the card.
// * A TMA producer loads C_i once and keeps B_j and the x_j tiles of the
//   pair's heads in a two-stage mbarrier ring (B_j on one barrier, x_j on
//   another, so the scores start while x is in flight).  x (Bc, Q, H, P)
//   goes through a 4-D map over (P, Q, H, Bc), so a head's tile is one box,
//   without a copy; rows past Q and heads past H arrive as zeros.  The
//   producer warp's lanes also copy cum_j and dt_j of the pair's heads
//   into the stage (plain loads: H needs no alignment) and arrive on B_j's
//   barrier.
// * S = C_i B_j^T is one bf16 wgmma chain (m64n64k16, both operands in
//   shared memory, K-major, ceil(N / 16) steps) with fp32 sums, formed ONCE
//   per j-tile for both heads.  S is not zeroed first (the first step
//   overwrites it): a register written outside the chain would make ptxas
//   serialise the wgmma.
// * Then for each head: W = S * exp(cum_i - cum_j) * dt_j in fp32, where
//   j <= i and i < Q: above the diagonal exp is never evaluated, since
//   there the exponent is positive and may overflow; only the diagonal and
//   the ragged tile test each element.  The exponent is the difference of
//   the raw cums, scaled afterwards (scaling each cum first loses digits
//   to cancellation when |cum| is in the hundreds).
// * y_h += W x_j with W in registers (the accumulator layout is the A
//   layout) and x_j MN-major in shared memory, W fed as kParts bf16 parts
//   (hi, the bf16 of what hi leaves out, and of what both leave), one
//   wgmma each into the same fp32 sums.  The wrapper passes W_PARTS = 3:
//   W is then exact to fp32 rounding.  K3 feeds P as two parts (2^-16 of
//   each weight); here two parts keep each call within K4_RTOL too, but
//   through 48 random bf16 layers mamba2-780m's logits then fail
//   chip_smoke's SERVE_RTOL check against the plain versions' at half the
//   seeds, where three parts read as close as K4 in float64 does
//   (chip_k4_logits.py builds on the two-part instance kept here;
//   tests/test_torch_ssm.py emulates one, two and three parts).
// * Tiles above the diagonal are never loaded.  y is written straight from
//   the accumulators, rows past Q and heads past H masked.
//
// fp32 inputs keep the first version's body: fp32 FMA on shared-memory
// tiles, one CTA of 256 threads per (64-row i-tile, head, chunk row), the
// scores recomputed per head.  No card path passes fp32 x / B / C (the
// models pass bf16); the instance stays for the wrapper's fp32 contract.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;          // rows of an i-tile and of a j-tile
constexpr int kP = 64;          // head dim P (columns of x and y)

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kHeads = 2;                    // heads per CTA (see above)
constexpr int kConsumers = 128;              // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = kConsumers + 32;  // + the producer warp

struct Params {
  const float* dt;
  const float* cum;
  float* y;
  int Q, H, N;
};

// dynamic shared memory for state size N (1 KB for the swizzle alignment)
size_t wg_smem_bytes(int N) {
  const int nbox = (N + kBoxCols - 1) / kBoxCols;
  return 1024 + (size_t)kBoxBytes * (3 * nbox + 2 * kHeads) +
         2 * (size_t)kT * kHeads * 8;
}

// W = S * exp(ci - cj) * dt_j of one head as kParts (2 or 3) bf16 A
// operands a[0] + ... (k16 step kk holds columns 16kk..16kk+15, the
// accumulator blocks 2kk and 2kk + 1).  kMasked: the diagonal tile (only
// j <= i) or the ragged one (only i < Q); elsewhere every element is below
// the diagonal.
template <int kParts, bool kMasked>
__device__ __forceinline__ void head_w(const float (&sc)[32],
                                       const float2* cd, int hh,
                                       const float (&ci)[2], int j0, int r0,
                                       int cq, bool diag, int Q,
                                       uint32_t (&a)[kParts][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float w2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 8 * kk + 2 * i + e;
        const int lc = 8 * (idx >> 2) + cq + e;      // column in the tile
        const int row = r0 + 8 * (i & 1);
        float w = 0.f;
        if (!kMasked || ((!diag || j0 + lc <= row) && row < Q)) {
          const float2 c = cd[lc * kHeads + hh];
          w = sc[idx] * exp2f((ci[i & 1] - c.x) * kLog2e) * c.y;
        }
        w2[e] = w;
      }
      // hi, then the bf16 of what hi leaves out, then of what both leave
      const __nv_bfloat162 h = __floats2bfloat162_rn(w2[0], w2[1]);
      const float2 hf = __bfloat1622float2(h);
      a[0][kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      if constexpr (kParts == 2)
        a[1][kk][i] = pack_bf16(w2[0] - hf.x, w2[1] - hf.y);
      else
        split_bf16(w2[0] - hf.x, w2[1] - hf.y, a[1][kk][i], a[2][kk][i]);
    }
  }
}

template <int kParts>
__global__ void __launch_bounds__(kWgThreads, 2)
ssd_intra_wgmma_kernel(const __grid_constant__ CUtensorMap tc,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tx,
                       const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * 2];
  const int Q = p.Q, H = p.H, N = p.N;
  const int nbox = (N + kBoxCols - 1) / kBoxCols;
  const int nk = (N + 15) / 16;                  // k16 steps of C_i B_j^T
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sc_tile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sc_tile + nbox * kBoxBytes;        // + stage
  const uint32_t sx = sb + 2 * nbox * kBoxBytes;         // + stage
  const uint32_t scd = sx + 2 * kHeads * kBoxBytes;      // + stage
  float2* cd_base = reinterpret_cast<float2*>(
      smem_raw + (scd - smem_u32(smem_raw)));
  const uint32_t bar_c = smem_u32(&bars[0]);
  const uint32_t bar_b = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_x = smem_u32(&bars[3]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[5]);         // + 8 * stage

  const int it = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int i0 = it * kT;
  const int h0 = blockIdx.y * kHeads;
  const int b = blockIdx.z;
  const int nh = min(kHeads, H - h0);            // heads of this CTA
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_c, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_b + 8 * s, 1 + 32);          // TMA bytes + 32 lanes
      mbar_init(bar_x + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: lane 0 issues the TMA loads, every lane copies cum / dt
    const int pl = tid - kConsumers;
    if (pl == 0) {
      mbar_expect_tx(bar_c, nbox * kBoxBytes);
      for (int x = 0; x < nbox; ++x)
        tma_load(sc_tile + x * kBoxBytes, &tc, bar_c, x * kBoxCols, i0, 0, b);
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int s = jt & 1;
      const int j0 = jt * kT;
      mbar_wait(bar_empty + 8 * s, ((jt >> 1) & 1) ^ 1);
      if (pl == 0) {
        const uint32_t b_dst = sb + s * nbox * kBoxBytes;
        mbar_expect_tx(bar_b + 8 * s, nbox * kBoxBytes);
        for (int x = 0; x < nbox; ++x)
          tma_load(b_dst + x * kBoxBytes, &tb, bar_b + 8 * s, x * kBoxCols,
                   j0, 0, b);
        const uint32_t x_dst = sx + s * kHeads * kBoxBytes;
        mbar_expect_tx(bar_x + 8 * s, nh * kBoxBytes);
        for (int hh = 0; hh < nh; ++hh)
          tma_load(x_dst + hh * kBoxBytes, &tx, bar_x + 8 * s, 0, j0, h0 + hh,
                   b);
      }
      float2* cd = cd_base + s * kT * kHeads;
      for (int e = pl; e < kT * kHeads; e += 32) {
        const int gj = j0 + e / kHeads;
        const int h = h0 + e % kHeads;
        float2 v = make_float2(0.f, 0.f);
        if (gj < Q && h < H) {
          const long long idx = ((long long)b * Q + gj) * H + h;
          v = make_float2(p.cum[idx], p.dt[idx]);
        }
        cd[e] = v;
      }
      mbar_arrive(bar_b + 8 * s);      // releases this lane's cum / dt
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w..16w+15 of the i-tile; a thread
  // holds rows r0 and r0 + 8, columns 8j + 2 (lane % 4) + {0, 1}
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = i0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float ci[2][kHeads];                 // cum of rows r0 and r1
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = h0 + hh;
    const long long i_r0 = ((long long)b * Q + r0) * H + h;
    ci[0][hh] = r0 < Q && h < H ? p.cum[i_r0] : 0.f;
    ci[1][hh] = r1 < Q && h < H ? p.cum[i_r0 + 8LL * H] : 0.f;
  }
  float y[kHeads][32];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[hh][i] = 0.f;
  const bool edge = i0 + kT > Q;       // the i-tile holds rows past Q

  mbar_wait(bar_c, 0);
  for (int jt = 0; jt <= it; ++jt) {
    const int s = jt & 1;
    const uint32_t phase = (jt >> 1) & 1;
    const int j0 = jt * kT;
    const bool diag = jt == it;
    mbar_wait(bar_b + 8 * s, phase);

    // S = C_i B_j^T, once for the group's heads
    const uint32_t b_tile = sb + s * nbox * kBoxBytes;
    // not zeroed: the first step overwrites (scale_d = 0), and a register
    // written outside the wgmma chain would make ptxas serialise it
    float sc[32];
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk)
      wgmma_ss_n64(sc, kmajor_desc(sc_tile, kk), kmajor_desc(b_tile, kk),
                   kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const float2* cd = cd_base + s * kT * kHeads;
    const uint32_t x_tile = sx + s * kHeads * kBoxBytes;
    mbar_wait(bar_x + 8 * s, phase);
    // W of each head in kParts bf16 parts, then y_h += W x_j
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) break;
      uint32_t a[kParts][4][4];
      const float cih[2] = {ci[0][hh], ci[1][hh]};
      if (diag || edge)
        head_w<kParts, true>(sc, cd, hh, cih, j0, r0, cq, diag, Q, a);
      else
        head_w<kParts, false>(sc, cd, hh, cih, j0, r0, cq, diag, Q, a);
      const uint32_t xh = x_tile + hh * kBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int part = 0; part < kParts; ++part)
          wgmma_rs_n64(y[hh], a[part][kk], vmajor_desc(xh, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y[hh]);
    }
    mbar_arrive(bar_empty + 8 * s);    // this stage's tiles are read
  }

#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh >= nh) break;
    float* yh = p.y + (long long)b * Q * H * kP + (long long)(h0 + hh) * kP;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq;
      if (r0 < Q)
        *reinterpret_cast<float2*>(yh + (long long)r0 * H * kP + col) =
            make_float2(y[hh][4 * j], y[hh][4 * j + 1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(yh + (long long)r1 * H * kP + col) =
            make_float2(y[hh][4 * j + 2], y[hh][4 * j + 3]);
    }
  }
}

template <int kParts>
int launch_wgmma(void* x, const void* dt, const void* cum, void* Bm, void* Cm,
                 void* y, int batch, int Q, int H, int N, cudaStream_t st) {
  const size_t smem = wg_smem_bytes(N);
  static size_t allowed = 48 * 1024;   // raised once per larger state
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_wgmma_kernel<kParts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  // C / B as (N, Q, 1, Bc); x as (P, Q, H, Bc): a head's tile is one box
  CUtensorMap tc, tb, tx;
  int err = make_map(&tc, Cm, N, Q, 1, batch, N, N, (long long)Q * N);
  if (!err) err = make_map(&tb, Bm, N, Q, 1, batch, N, N, (long long)Q * N);
  if (!err)
    err = make_map(&tx, x, kP, Q, H, batch, (long long)H * kP, kP,
                   (long long)Q * H * kP);
  if (err) return err;
  Params p;
  p.dt = reinterpret_cast<const float*>(dt);
  p.cum = reinterpret_cast<const float*>(cum);
  p.y = reinterpret_cast<float*>(y);
  p.Q = Q;
  p.H = H;
  p.N = N;
  dim3 grid((Q + kT - 1) / kT, (H + kHeads - 1) / kHeads, batch);
  ssd_intra_wgmma_kernel<kParts><<<grid, kWgThreads, smem, st>>>(tc, tb, tx,
                                                                 p);
  return (int)cudaGetLastError();
}

// ---- fp32: the first version's FMA body ----------------------------------

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTS = kT + 4;     // padded stride of the transposed tiles

__global__ void __launch_bounds__(kThreads)
ssd_intra_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     int Q, int H, int N) {
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

  const float* Cb = Cm + (long long)b * Q * N;
  const float* Bb = Bm + (long long)b * Q * N;
  const float* dtb = dt + (long long)b * Q * H + h;
  const float* cumb = cum + (long long)b * Q * H + h;
  const float* xb = x + ((long long)b * Q * H + h) * kP;

  // C_i, transposed; consecutive threads read consecutive n (coalesced)
  for (int e = tid; e < kT * N; e += kThreads) {
    const int r = e / N, n = e % N;
    const int gi = i0 + r;
    Ct[n * kTS + r] = gi < Q ? Cb[(long long)gi * N + n] : 0.f;
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
      Bt[n * kTS + r] = gj < Q ? Bb[(long long)gj * N + n] : 0.f;
    }
    for (int e = tid; e < kT * kP; e += kThreads) {
      const int r = e / kP, p = e % kP;
      const int gj = j0 + r;
      Xs[r * kP + p] =
          gj < Q ? xb[(long long)gj * H * kP + p] : 0.f;
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

size_t fma_smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)2 * N * kTS + kT * kP + kT * kTS + 3 * kT);
}

int launch_fma(const void* x, const void* dt, const void* cum, const void* Bm,
               const void* Cm, void* y, int batch, int Q, int H, int N,
               cudaStream_t st) {
  const size_t smem = fma_smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Q + kT - 1) / kT, H, batch);
  ssd_intra_fma_kernel<<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(dt),
      reinterpret_cast<const float*>(cum), reinterpret_cast<const float*>(Bm),
      reinterpret_cast<const float*>(Cm), reinterpret_cast<float*>(y), Q, H,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

// The heads per CTA of the bf16 kernel, which the wrapper states again for
// the CPU emulation (chip_smoke.py holds the two copies equal).
extern "C" int rc_ssd_heads_per_cta() { return kHeads; }

// dtype: 0 = fp32 inputs x / B / C (FMA body), 1 = bf16 (tensor cores; N a
// multiple of 8 and 16-byte aligned x / B / C, which the wrapper checks;
// w_parts, 2 or 3, the bf16 parts of W).  P is fixed at 64.  A tensor-map
// failure gives 10000 + its CUresult.
extern "C" int rc_ssd_intra_chunk(void* x, void* dt, void* cum, void* Bm,
                                  void* Cm, void* y, int batch, int Q, int H,
                                  int N, int dtype, int w_parts,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fma(x, dt, cum, Bm, Cm, y, batch, Q, H, N, st);
  if (w_parts == 3)
    return launch_wgmma<3>(x, dt, cum, Bm, Cm, y, batch, Q, H, N, st);
  if (w_parts == 2)
    return launch_wgmma<2>(x, dt, cum, Bm, Cm, y, batch, Q, H, N, st);
  return (int)cudaErrorInvalidValue;
}
