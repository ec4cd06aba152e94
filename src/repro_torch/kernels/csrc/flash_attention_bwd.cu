// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of
//   repro/kernels/flash_attention.py::flash_attention_bwd:
//   _flash_bwd_kernel (dk, dv; grid (BH, kv blocks, q blocks), q innermost) and
//   _flash_dq_kernel  (dq;     grid (BH, q blocks, kv blocks), kv innermost).
//
// Given q, k, v, dO (BH, S, hd), the forward's row statistics lse (BH, Sq)
// and delta = sum_d dO * O (BH, Sq), both fp32, each kernel recomputes the
// probabilities p = exp(q k^T * scale - lse) (masked entries exactly 0) and
//   dV = p^T dO,  dS = p * (dO v^T - delta),  dK = dS^T q * scale  (dkdv)
//   dQ = dS k * scale                                              (dq)
// delta is computed outside, as the reference computes it outside any kernel.
//
// What differs from the TPU kernels. There the innermost grid axis runs in
// order on one core and the dk/dv (or dq) accumulator lives in VMEM scratch.
// Here one thread block owns one (bh, 64-row kv tile) for dk/dv, or one (bh,
// 64-row q tile) for dq, and walks the other axis in a loop of its own with
// the accumulators in registers. Each output element is written by exactly
// one block, with no atomics, so the gradients are deterministic: a
// recomputed forward gives the same gradients bit for bit. Under causality
// the dk/dv block starts its q loop at the diagonal (the TPU kernel's
// `needed`, reversed) and the dq block stops its kv loop there. Rows past Sq
// and columns past Sk are masked here, so any S works.
//
// What bounds it. The five products of the backward (2*BH*Sq*Sk*hd
// operations each, half of it when causal) make it operation-bound at the
// training shapes in bf16, and in fp32 (67 TFLOP/s outside the tensor cores).
// One kernel per input type:
//
//  * bf16 — tensor cores (mma.sync m16n8k16, fp32 accumulate). In dkdv a warp
//    owns 16 kv rows: S^T = K Q^T and dP^T = V dO^T land in accumulator
//    registers, and p^T and dS^T, rounded to bf16, are directly the A operand
//    of dV += p^T dO and dK += dS^T Q, whose B operands are dO and Q stored
//    transposed in shared memory. In dq a warp owns 16 q rows the same way and
//    dS, rounded to bf16, feeds dQ += dS K with K stored transposed.
//    Register pressure sets the q tile of dkdv: its dK and dV accumulators
//    are hd/2 fp32 registers each per thread (128 at hd = 128), beside the
//    score and dP tiles (q tile / 2 each); the q tile is 64 rows for hd <= 64
//    and 32 rows at hd = 128, so that ptxas keeps everything in registers
//    (checked with -Xptxas -v in the build; no spills).
//  * fp32 — true fp32 FMA on the CUDA cores (no TF32), as the reference holds
//    fp32 gradients to 1e-4. 256 threads; each keeps a 4x4 tile of scores and
//    4 x hd/16 tiles of its accumulators in registers; p and dS go through
//    shared memory for the second products. Their tiles take 105-171 KB of
//    shared memory, so one block fills an SM: the launch bounds say so, and
//    ptxas may then give a thread up to 255 registers (at the default it
//    held them to 128 and spilled in dq at hd = 128 and dkdv at hd = 64).
//
// Neither overlaps loads with products (no cp.async / TMA ring) and neither
// uses wgmma; that is later work behind the same interface.
//
// Inputs fp32 or bf16, head dim 16, 32, 64 or 128, outputs in the input type.
#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_bf16_m16n8k16;
using flash::pack_bf16;
using flash::st32;

// ---------------------------------------------------------------------------
// fp32: FMA kernels, 16 x 16 threads, 64 x 64 score tiles
// ---------------------------------------------------------------------------
constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // kv rows per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;      // 256 threads
constexpr int PP = 64 + 4;       // pitch of the p / dS tiles

// Output columns of a thread in a (64, HD) accumulator: (tx + TX*jv)*VEC + e.
template <int HD> struct Cols {
  static constexpr int VEC = (HD % 64 == 0) ? 4 : 1;
  static constexpr int NV = HD / (TX * VEC);
  static constexpr int OC = NV * VEC;
};

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+TX*j][d] over fp32 tiles of pitch HD+4.
template <int HD>
__device__ __forceinline__ void dot_4x4(float (&s)[4][4], const float* A,
                                        const float* B, int tx, int ty) {
  constexpr int PITCH = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * PITCH + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + TX * j) * PITCH + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_r P[ty*4+i][r] * X[r][col(c)], P of pitch PP, X of pitch
// HD+4, r over 64 rows.
template <int HD>
__device__ __forceinline__ void acc_px(float (&acc)[4][Cols<HD>::OC],
                                       const float* P, const float* X, int tx,
                                       int ty) {
  constexpr int PITCH = HD + 4;
  constexpr int VEC = Cols<HD>::VEC;
  constexpr int NV = Cols<HD>::NV;
#pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * PP + kk);
      p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xrow = X + (kk + u) * PITCH;
#pragma unroll
      for (int jv = 0; jv < NV; ++jv) {
        float xv[VEC];
        if constexpr (VEC == 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(xrow + (tx + TX * jv) * 4);
          xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
        } else {
          xv[0] = xrow[tx + TX * jv];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][jv * VEC + e] = fmaf(p[i][u], xv[e], acc[i][jv * VEC + e]);
      }
    }
  }
}

// Write a thread's accumulator rows (ty*4+i) into an fp32 tile of pitch HD+4.
template <int HD>
__device__ __forceinline__ void stage_acc(float* dst,
                                          const float (&acc)[4][Cols<HD>::OC],
                                          float mul, int tx, int ty) {
  constexpr int PITCH = HD + 4;
  constexpr int VEC = Cols<HD>::VEC;
  constexpr int NV = Cols<HD>::NV;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jv = 0; jv < NV; ++jv)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[(ty * 4 + i) * PITCH + (tx + TX * jv) * VEC + e] =
            acc[i][jv * VEC + e] * mul;
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int BH, int Sq,
                int Sk, int causal, float scale) {
  constexpr int PITCH = HD + 4;
  constexpr int OC = Cols<HD>::OC;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // (BK, PITCH), then dK
  float* Vs = Ks + BK * PITCH;       // (BK, PITCH), then dV
  float* Qs = Vs + BK * PITCH;       // (BQ, PITCH), q * scale
  float* dOs = Qs + BQ * PITCH;      // (BQ, PITCH)
  float* Ps = dOs + BQ * PITCH;      // (BK, PP), p^T
  float* dSs = Ps + BK * PP;         // (BK, PP), dS^T
  float* Ls = dSs + BK * PP;         // (BQ), lse of the q tile
  float* Ds = Ls + BQ;               // (BQ), delta of the q tile

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int kt = static_cast<int>(blockIdx.x) / BH;  // kv tile 0 is heaviest
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int k0 = kt * BK;
  const int k_valid = min(BK, Sk - k0);
  const size_t qrow0 = static_cast<size_t>(bh) * Sq;
  const size_t krow0 = static_cast<size_t>(bh) * Sk + k0;

  flash::load_tile<float, HD, BK, NT>(Ks, k + krow0 * HD, k_valid, 1.f);
  flash::load_tile<float, HD, BK, NT>(Vs, v + krow0 * HD, k_valid, 1.f);

  float dk_acc[4][OC], dv_acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int iq = causal ? k0 / BQ : 0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    const int q_valid = min(BQ, Sq - q0);
    __syncthreads();  // the previous tile is no longer read
    flash::load_tile<float, HD, BQ, NT>(Qs, q + (qrow0 + q0) * HD, q_valid, scale);
    flash::load_tile<float, HD, BQ, NT>(dOs, dout + (qrow0 + q0) * HD, q_valid, 1.f);
    if (tid < BQ) {
      Ls[tid] = tid < q_valid ? lse[qrow0 + q0 + tid] : 0.f;
      Ds[tid] = tid < q_valid ? delta[qrow0 + q0 + tid] : 0.f;
    }
    __syncthreads();

    // p^T[kv][q] for kv = k0 + ty*4 + i, q = q0 + tx + TX*j
    float s[4][4], dp[4][4];
    dot_4x4<HD>(s, Ks, Qs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kv = k0 + ty * 4 + i;
        const int qq = q0 + tx + TX * j;
        const bool keep = kv < Sk && qq < Sq && (!causal || qq >= kv);
        s[i][j] = keep ? expf(s[i][j] - Ls[tx + TX * j]) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + TX * j] = s[i][j];
      }
    dot_4x4<HD>(dp, Vs, dOs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty * 4 + i) * PP + tx + TX * j] =
            s[i][j] * (dp[i][j] - Ds[tx + TX * j]);
    __syncthreads();
    acc_px<HD>(dv_acc, Ps, dOs, tx, ty);
    acc_px<HD>(dk_acc, dSs, Qs, tx, ty);
  }

  __syncthreads();  // Ks and Vs become the output tiles
  stage_acc<HD>(Ks, dk_acc, 1.f, tx, ty);
  stage_acc<HD>(Vs, dv_acc, 1.f, tx, ty);
  __syncthreads();
  flash::store_tile<float, HD, BK, NT>(dk + krow0 * HD, Ks, k_valid);
  flash::store_tile<float, HD, BK, NT>(dv + krow0 * HD, Vs, k_valid);
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int BH, int Sq, int Sk, int causal,
              float scale) {
  constexpr int PITCH = HD + 4;
  constexpr int OC = Cols<HD>::OC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // (BQ, PITCH), q * scale, then dQ
  float* dOs = Qs + BQ * PITCH;      // (BQ, PITCH)
  float* Ks = dOs + BQ * PITCH;      // (BK, PITCH)
  float* Vs = Ks + BK * PITCH;       // (BK, PITCH)
  float* dSs = Vs + BK * PITCH;      // (BQ, PP)

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * Sq + q0;
  const size_t krow0 = static_cast<size_t>(bh) * Sk;

  flash::load_tile<float, HD, BQ, NT>(Qs, q + qrow0 * HD, q_valid, scale);
  flash::load_tile<float, HD, BQ, NT>(dOs, dout + qrow0 * HD, q_valid, 1.f);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    lse_r[i] = r < q_valid ? lse[qrow0 + r] : 0.f;
    delta_r[i] = r < q_valid ? delta[qrow0 + r] : 0.f;
  }

  float dq_acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dq_acc[i][c] = 0.f;

  int nkv = (Sk + BK - 1) / BK;
  if (causal) nkv = min(nkv, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * BK;
    const int k_valid = min(BK, Sk - k0);
    __syncthreads();  // the previous tile is no longer read
    flash::load_tile<float, HD, BK, NT>(Ks, k + (krow0 + k0) * HD, k_valid, 1.f);
    flash::load_tile<float, HD, BK, NT>(Vs, v + (krow0 + k0) * HD, k_valid, 1.f);
    __syncthreads();

    // p[q][kv] for q = q0 + ty*4 + i, kv = k0 + tx + TX*j
    float s[4][4], dp[4][4];
    dot_4x4<HD>(s, Qs, Ks, tx, ty);
    dot_4x4<HD>(dp, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = q0 + ty * 4 + i;
        const int kv = k0 + tx + TX * j;
        const bool keep = qq < Sq && kv < Sk && (!causal || qq >= kv);
        const float p = keep ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * PP + tx + TX * j] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();
    acc_px<HD>(dq_acc, dSs, Ks, tx, ty);
  }

  __syncthreads();  // Qs becomes the output tile
  stage_acc<HD>(Qs, dq_acc, scale, tx, ty);
  __syncthreads();
  flash::store_tile<float, HD, BQ, NT>(dq + qrow0 * HD, Qs, q_valid);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels, 4 warps, 16 rows a warp
// ---------------------------------------------------------------------------
constexpr int MT = 128;

// q rows per tile of the dkdv kernel (see the header on register pressure)
template <int HD> struct DkdvTile { static constexpr int BMQ = HD <= 64 ? 64 : 32; };

template <int HD>
__global__ void __launch_bounds__(MT)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int BH, int Sq, int Sk,
                    int causal, float scale) {
  constexpr int BMQ = DkdvTile<HD>::BMQ;
  constexpr int KP = HD + 8;     // pitch of the row-major tiles
  constexpr int TP = BMQ + 8;    // pitch of the transposed (HD, BMQ) tiles
  constexpr int KS = HD / 16;    // k-steps over hd
  constexpr int NQ = BMQ / 8;    // 8-wide column tiles over the q tile
  constexpr int KQ = BMQ / 16;   // k-steps over the q tile
  constexpr int ND = HD / 8;     // 8-wide column tiles over hd

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BK, KP)
  __nv_bfloat16* Vs = Ks + BK * KP;                                // (BK, KP)
  __nv_bfloat16* Qs = Vs + BK * KP;                                // (BMQ, KP)
  __nv_bfloat16* dOs = Qs + BMQ * KP;                              // (BMQ, KP)
  __nv_bfloat16* Qt = dOs + BMQ * KP;                              // (HD, TP)
  __nv_bfloat16* dOt = Qt + HD * TP;                               // (HD, TP)
  float* Ls = reinterpret_cast<float*>(dOt + HD * TP);             // (BMQ)
  float* Ds = Ls + BMQ;                                            // (BMQ)

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first kv row
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int kt = static_cast<int>(blockIdx.x) / BH;  // kv tile 0 is heaviest
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int k0 = kt * BK;
  const int k_valid = min(BK, Sk - k0);
  const size_t qrow0 = static_cast<size_t>(bh) * Sq;
  const size_t krow0 = static_cast<size_t>(bh) * Sk + k0;

  flash::load_tile_bf16<HD, BK, MT>(Ks, k + krow0 * HD, k_valid);
  flash::load_tile_bf16<HD, BK, MT>(Vs, v + krow0 * HD, k_valid);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  const int nq = (Sq + BMQ - 1) / BMQ;
  for (int iq = causal ? k0 / BMQ : 0; iq < nq; ++iq) {
    const int q0 = iq * BMQ;
    const int q_valid = min(BMQ, Sq - q0);
    __syncthreads();  // the previous tile is no longer read
    const __nv_bfloat16* qt = q + (qrow0 + q0) * HD;
    const __nv_bfloat16* dot = dout + (qrow0 + q0) * HD;
    flash::load_tile_bf16<HD, BMQ, MT>(Qs, qt, q_valid);
    flash::load_tile_bf16<HD, BMQ, MT>(dOs, dot, q_valid);
    flash::load_tile_bf16_transposed<HD, BMQ, MT>(Qt, qt, q_valid);
    flash::load_tile_bf16_transposed<HD, BMQ, MT>(dOt, dot, q_valid);
    for (int i = threadIdx.x; i < BMQ; i += MT) {
      Ls[i] = i < q_valid ? lse[qrow0 + q0 + i] : 0.f;
      Ds[i] = i < q_valid ? delta[qrow0 + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* ka = Ks + (r0 + g) * KP + ks * 16 + 2 * tig;
      const __nv_bfloat16* va = Vs + (r0 + g) * KP + ks * 16 + 2 * tig;
      const uint32_t a_k[4] = {ld32(ka), ld32(ka + 8 * KP), ld32(ka + 8),
                               ld32(ka + 8 * KP + 8)};
      const uint32_t a_v[4] = {ld32(va), ld32(va + 8 * KP), ld32(va + 8),
                               ld32(va + 8 * KP + 8)};
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const __nv_bfloat16* qb = Qs + (n * 8 + g) * KP + ks * 16 + 2 * tig;
        const __nv_bfloat16* ob = dOs + (n * 8 + g) * KP + ks * 16 + 2 * tig;
        mma_bf16_m16n8k16(s[n], a_k, ld32(qb), ld32(qb + 8));
        mma_bf16_m16n8k16(dp[n], a_v, ld32(ob), ld32(ob + 8));
      }
    }

    // p^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kv = k0 + r0 + g + (c >> 1) * 8;
        const int qc = n * 8 + 2 * tig + (c & 1);
        const int qq = q0 + qc;
        const bool keep = kv < Sk && qq < Sq && (!causal || qq >= kv);
        const float p = keep ? expf(s[n][c] * scale - Ls[qc]) : 0.f;
        s[n][c] = p;
        dp[n][c] = p * (dp[n][c] - Ds[qc]);
      }

    // dV += p^T dO and dK += dS^T Q: two neighbouring column tiles of the
    // accumulators, rounded to bf16, are the A operand of one k-step
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const uint32_t a_p[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                               pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                               pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                               pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
      const uint32_t a_ds[4] = {pack_bf16(dp[2 * kq][0], dp[2 * kq][1]),
                                pack_bf16(dp[2 * kq][2], dp[2 * kq][3]),
                                pack_bf16(dp[2 * kq + 1][0], dp[2 * kq + 1][1]),
                                pack_bf16(dp[2 * kq + 1][2], dp[2 * kq + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* ob = dOt + (n * 8 + g) * TP + kq * 16 + 2 * tig;
        const __nv_bfloat16* qb = Qt + (n * 8 + g) * TP + kq * 16 + 2 * tig;
        mma_bf16_m16n8k16(dv_acc[n], a_p, ld32(ob), ld32(ob + 8));
        mma_bf16_m16n8k16(dk_acc[n], a_ds, ld32(qb), ld32(qb + 8));
      }
    }
  }

  // a warp reads only its own 16 rows of Ks and Vs, so it may overwrite them
  // with its dK and dV rows; then the block stores both tiles
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    __nv_bfloat16* kd = Ks + (r0 + g) * KP + n * 8 + 2 * tig;
    __nv_bfloat16* vd = Vs + (r0 + g) * KP + n * 8 + 2 * tig;
    st32(kd, pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale));
    st32(kd + 8 * KP, pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale));
    st32(vd, pack_bf16(dv_acc[n][0], dv_acc[n][1]));
    st32(vd + 8 * KP, pack_bf16(dv_acc[n][2], dv_acc[n][3]));
  }
  __syncthreads();
  flash::store_tile_bf16<HD, BK, MT>(dk + krow0 * HD, Ks, k_valid);
  flash::store_tile_bf16<HD, BK, MT>(dv + krow0 * HD, Vs, k_valid);
}

template <int HD>
__global__ void __launch_bounds__(MT)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int BH, int Sq, int Sk,
                  int causal, float scale) {
  constexpr int KP = HD + 8;     // pitch of the row-major tiles
  constexpr int TP = BK + 8;     // pitch of the transposed K tile
  constexpr int KS = HD / 16;    // k-steps over hd
  constexpr int NK = BK / 8;     // 8-wide column tiles over the kv tile
  constexpr int KK = BK / 16;    // k-steps over the kv tile
  constexpr int ND = HD / 8;     // 8-wide column tiles over hd

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BQ, KP)
  __nv_bfloat16* dOs = Qs + BQ * KP;                               // (BQ, KP)
  __nv_bfloat16* Ks = dOs + BQ * KP;                               // (BK, KP)
  __nv_bfloat16* Vs = Ks + BK * KP;                                // (BK, KP)
  __nv_bfloat16* Kt = Vs + BK * KP;                                // (HD, TP)

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first q row
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const size_t qrow0 = static_cast<size_t>(bh) * Sq + q0;
  const size_t krow0 = static_cast<size_t>(bh) * Sk;

  flash::load_tile_bf16<HD, BQ, MT>(Qs, q + qrow0 * HD, q_valid);
  flash::load_tile_bf16<HD, BQ, MT>(dOs, dout + qrow0 * HD, q_valid);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + h * 8;
    lse_r[h] = r < q_valid ? lse[qrow0 + r] : 0.f;
    delta_r[h] = r < q_valid ? delta[qrow0 + r] : 0.f;
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[n][c] = 0.f;

  int nkv = (Sk + BK - 1) / BK;
  if (causal) nkv = min(nkv, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * BK;
    const int k_valid = min(BK, Sk - k0);
    __syncthreads();  // the previous tile is no longer read
    const __nv_bfloat16* kb = k + (krow0 + k0) * HD;
    flash::load_tile_bf16<HD, BK, MT>(Ks, kb, k_valid);
    flash::load_tile_bf16<HD, BK, MT>(Vs, v + (krow0 + k0) * HD, k_valid);
    flash::load_tile_bf16_transposed<HD, BK, MT>(Kt, kb, k_valid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 q rows
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* qa = Qs + (r0 + g) * KP + ks * 16 + 2 * tig;
      const __nv_bfloat16* oa = dOs + (r0 + g) * KP + ks * 16 + 2 * tig;
      const uint32_t a_q[4] = {ld32(qa), ld32(qa + 8 * KP), ld32(qa + 8),
                               ld32(qa + 8 * KP + 8)};
      const uint32_t a_o[4] = {ld32(oa), ld32(oa + 8 * KP), ld32(oa + 8),
                               ld32(oa + 8 * KP + 8)};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const __nv_bfloat16* kb2 = Ks + (n * 8 + g) * KP + ks * 16 + 2 * tig;
        const __nv_bfloat16* vb2 = Vs + (n * 8 + g) * KP + ks * 16 + 2 * tig;
        mma_bf16_m16n8k16(s[n], a_q, ld32(kb2), ld32(kb2 + 8));
        mma_bf16_m16n8k16(dp[n], a_o, ld32(vb2), ld32(vb2 + 8));
      }
    }

    // dS = p * (dP - delta) in place of dP
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qq = q0 + r0 + g + (c >> 1) * 8;
        const int kv = k0 + n * 8 + 2 * tig + (c & 1);
        const bool keep = qq < Sq && kv < Sk && (!causal || qq >= kv);
        const float p = keep ? expf(s[n][c] * scale - lse_r[c >> 1]) : 0.f;
        dp[n][c] = p * (dp[n][c] - delta_r[c >> 1]);
      }

    // dQ += dS K, with dS rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t a_ds[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* kb2 = Kt + (n * 8 + g) * TP + kk * 16 + 2 * tig;
        mma_bf16_m16n8k16(dq_acc[n], a_ds, ld32(kb2), ld32(kb2 + 8));
      }
    }
  }

  // a warp reads only its own 16 rows of Qs: it overwrites them with dQ
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    __nv_bfloat16* d = Qs + (r0 + g) * KP + n * 8 + 2 * tig;
    st32(d, pack_bf16(dq_acc[n][0] * scale, dq_acc[n][1] * scale));
    st32(d + 8 * KP, pack_bf16(dq_acc[n][2] * scale, dq_acc[n][3] * scale));
  }
  __syncthreads();
  flash::store_tile_bf16<HD, BQ, MT>(dq + qrow0 * HD, Qs, q_valid);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kern>
cudaError_t launch_grid(Kern kern, size_t smem_bytes, int threads,
                        long long tiles, int BH, cudaStream_t stream,
                        void** args) {
  const void* fn = (const void*)kern;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = tiles * static_cast<long long>(BH);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(threads),
                         args, smem_bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta; void* o1; void* o2;
  int BH, Sq, Sk, causal; float scale;
};

template <int HD>
cudaError_t dkdv_hd(int dtype, Args a, cudaStream_t stream) {
  const long long tiles = (a.Sk + BK - 1) / BK;
  void* args[] = {&a.q, &a.k, &a.v, &a.dout, &a.lse, &a.delta, &a.o1, &a.o2,
                  &a.BH, &a.Sq, &a.Sk, &a.causal, &a.scale};
  if (dtype == 0) {
    constexpr size_t smem = (2 * BK * (HD + 4) + 2 * BQ * (HD + 4) + 2 * BK * PP +
                             2 * BQ) * sizeof(float);
    return launch_grid(bwd_dkdv_kernel<HD>, smem, NT, tiles, a.BH, stream, args);
  }
  constexpr int BMQ = DkdvTile<HD>::BMQ;
  constexpr size_t smem = (2 * BK * (HD + 8) + 2 * BMQ * (HD + 8) +
                           2 * HD * (BMQ + 8)) * sizeof(__nv_bfloat16) +
                          2 * BMQ * sizeof(float);
  return launch_grid(bwd_dkdv_mma_kernel<HD>, smem, MT, tiles, a.BH, stream, args);
}

template <int HD>
cudaError_t dq_hd(int dtype, Args a, cudaStream_t stream) {
  const long long tiles = (a.Sq + BQ - 1) / BQ;
  void* args[] = {&a.q, &a.k, &a.v, &a.dout, &a.lse, &a.delta, &a.o1,
                  &a.BH, &a.Sq, &a.Sk, &a.causal, &a.scale};
  if (dtype == 0) {
    constexpr size_t smem = (2 * BQ * (HD + 4) + 2 * BK * (HD + 4) + BQ * PP) *
                            sizeof(float);
    return launch_grid(bwd_dq_kernel<HD>, smem, NT, tiles, a.BH, stream, args);
  }
  constexpr size_t smem = (2 * BQ * (HD + 8) + 2 * BK * (HD + 8) +
                           HD * (BK + 8)) * sizeof(__nv_bfloat16);
  return launch_grid(bwd_dq_mma_kernel<HD>, smem, MT, tiles, a.BH, stream, args);
}

template <bool DKDV>
cudaError_t dispatch(int hd, int dtype, const Args& a, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define BWD_CASE(HD_) \
  case HD_: return DKDV ? dkdv_hd<HD_>(dtype, a, stream) : dq_hd<HD_>(dtype, a, stream);
  switch (hd) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout (BH, Sq, hd), k, v (BH, Sk, hd)
// contiguous in that type; lse, delta contiguous fp32 (BH, Sq); dk, dv
// (BH, Sk, hd) and dq (BH, Sq, hd) are written in the input type.
// Each returns the CUDA error code of its launch (0 = launched).
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv, int BH, int Sq,
                                        int Sk, int hd, int dtype, int causal,
                                        float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, causal, scale};
  return static_cast<int>(
      dispatch<true>(hd, dtype, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int BH, int Sq, int Sk, int hd,
                                      int dtype, int causal, float scale,
                                      void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, BH, Sq, Sk, causal, scale};
  return static_cast<int>(
      dispatch<false>(hd, dtype, a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
