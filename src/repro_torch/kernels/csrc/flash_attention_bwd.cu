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
// and columns past Sk are masked here, so any S works. The heaviest blocks
// are scheduled first: kv tile 0 for dk/dv, the last q tile for dq.
//
// What bounds it. The seven products of the backward (2*BH*Sq*Sk*hd
// operations each, half of it when causal; four in dkdv, three in dq) make
// it operation-bound at the training shapes in bf16, and in fp32 (67 TFLOP/s
// outside the tensor cores). One kernel per input type:
//
//  * bf16 — wgmma fed by TMA (flash_bwd_dkdv_wgmma_kernel,
//    flash_bwd_dq_wgmma_kernel). A block is one warpgroup, and two blocks
//    share an SM, so that one's tensor-core products overlap the other's
//    exponentials. In dkdv the K and V tiles land in swizzled shared memory
//    once, and (Q, dO) tiles of 64 q rows stream through a two-stage TMA
//    ring. Per q tile the warpgroup runs S^T = K Q^T and dP^T = V dO^T (both
//    operands K-major as TMA laid them down), forms p^T and dS^T in
//    registers, and runs dV += p^T dO and dK += dS^T Q with p^T and dS^T,
//    rounded to bf16, as the register A operand and dO and Q read MN-major
//    through the transpose bit. In dq, Q and dO land once and K and V stream
//    through the ring: S = Q K^T, dP = dO V^T, dQ += dS K with K read
//    MN-major. Nothing is transposed in shared memory. The products go out
//    in separate commit groups, so that the exponentials run while dP is
//    multiplied, and dS is formed while dV is. There is no producer warp:
//    lse and delta take plain loads (their fp32 rows need not be 16-byte
//    multiples, which TMA wants), and thread 0 refills a stage once a block
//    barrier shows every warp done with it. Four warps a block leave a
//    thread up to 255 registers with two blocks an SM (a fifth, producer,
//    warp capped it at 168, which dK and dV at hd 128 alone nearly fill).
//    What still bounds it: inside one warpgroup the exponentials and the
//    products still take turns in part (two blocks an SM hide some of it),
//    and the tiles are 64 x 64, so every wgmma is short.
//  * fp32 — true fp32 FMA on the CUDA cores (no TF32), as the reference holds
//    fp32 gradients to 1e-4. 256 threads; each keeps a 4x4 tile of scores and
//    4 x hd/16 tiles of its accumulators in registers; p and dS go through
//    shared memory for the second products. Their tiles take 105-171 KB of
//    shared memory, so one block fills an SM: the launch bounds say so, and
//    ptxas may then give a thread up to 255 registers (at the default it
//    held them to 128 and spilled in dq at hd = 128 and dkdv at hd = 64).
//    Loads do not overlap products.
//
// Every bf16 input the wrapper takes (contiguous, 16-byte aligned, rows of
// hd * 2 >= 32 bytes) is one a TMA descriptor takes, so bf16 has no other
// route. Inputs fp32 or bf16, head dim 16, 32, 64, 96 or 128, outputs in
// the input type. At head dim 96 (phi3-mini) the tiles are three 64-byte-
// swizzled chunks a row (hopper::swizzle_bytes) and dV, dK and dQ take
// m64n96k16 wgmmas; the accumulators are 96 registers a thread in dkdv,
// fewer than at 128.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::pack_bf16;

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
// bf16: wgmma on TMA rings, one warpgroup a block
// ---------------------------------------------------------------------------
constexpr int TILE = 64;           // rows of every tile: a block's own, and those it streams
constexpr int STAGES = 2;          // stages of either ring (deeper ones were no faster)
constexpr int WT = 128;            // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the MUFU unit, results below 2^-126 flushed to 0 (exp2f rescales
// around the instruction to keep them, which measured slower)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct BwdTile {
  static constexpr int SW = hopper::swizzle_bytes(HD * 2);  // swizzle: bytes a row of a chunk
  static constexpr int CH = HD * 2 / SW;                     // column chunks
  static constexpr int BOX = SW / 2;                        // elements a TMA box row
  static constexpr int BYTES = TILE * HD * 2;               // one tile
  // the block's two tiles and a ring of two a stage, 1 KB of alignment slack
  static constexpr int SMEM = (2 + 2 * STAGES) * BYTES + 1024;
};

// A tile from row `row` of head bh: one TMA box per column chunk, chunk c
// at c * TILE * SW.
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  using T = BwdTile<HD>;
#pragma unroll
  for (int c = 0; c < T::CH; ++c)
    hopper::tma_load_3d(dst + c * TILE * T::SW, map, bar, c * T::BOX, row, bh);
}

// Descriptors of k-step kk of a tile: K-major (hd is the product's K: 32
// bytes a step, inside the chunk that holds them), and MN-major (the tile's
// rows are the product's K: 16 rows a step, the column chunks TILE * SW
// bytes apart).
template <int HD>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk) {
  constexpr int SW = BwdTile<HD>::SW;
  return hopper::make_desc(tile + (kk * 32 / SW) * TILE * SW + kk * 32 % SW, 16,
                           8 * SW, SW);
}
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int kk) {
  constexpr int SW = BwdTile<HD>::SW;
  return hopper::make_desc(tile + kk * 16 * SW, TILE * SW, 8 * SW, SW);
}

// Accumulators rounded to bf16 as A fragments: those of two neighbouring
// 8-column groups are one 16-wide k-step.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4],
                                         const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Rows r and r + 8 of a 64-row accumulator (d[4j + 2h + e]: row r + 8h,
// column 8j + 2tq + e) to bf16 rows of HD at dst, each multiplied by mul,
// rows at or past `valid` skipped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&d)[HD / 2],
                                           int r, int tq, int valid, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= valid) continue;
    __nv_bfloat16* row = dst + static_cast<size_t>(r + 8 * h) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// dk/dv. qmap and domap (HD, Sq, BH), kmap and vmap (HD, Sk, BH), all with
// boxes of (BOX, TILE, 1); swizzled SW bytes.
template <int HD>
__global__ void __launch_bounds__(WT, 2)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int BH, int Sq,
                            int Sk, int causal, float scale_log2, float scale) {
  using T = BwdTile<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kvbar, full[STAGES];
  __shared__ __align__(16) float Ls[2][TILE];   // lse * log2(e) of tile t's rows at t & 1
  __shared__ __align__(16) float Ds[2][TILE];   // delta of the same rows
  unsigned char* Ks = hopper::align1024(smem_raw);
  unsigned char* Vs = Ks + T::BYTES;
  unsigned char* Qs = Vs + T::BYTES;             // stage s at s * BYTES
  unsigned char* dOs = Qs + STAGES * T::BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt = static_cast<int>(blockIdx.x) / BH;  // kv tile 0 is heaviest
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int k0 = kt * TILE;
  const int nq = (Sq + TILE - 1) / TILE;
  const int iq0 = causal ? min(k0 / TILE, nq) : 0;     // the diagonal's q tile
  const int ntiles = nq - iq0;
  const float* lse_bh = lse + static_cast<size_t>(bh) * Sq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * Sq;
  // thread tid < TILE reads lse and delta of row tid of q tile t
  auto stats = [&](int t, float& l, float& d) {
    const int row = (iq0 + t) * TILE + tid;
    const bool in = tid < TILE && t < ntiles && row < Sq;
    l = in ? lse_bh[row] * LOG2E : 0.f;
    d = in ? delta_bh[row] : 0.f;
  };
  auto load_q_tile = [&](int t) {   // (Q, dO) tile t into stage t % STAGES
    const int s = t % STAGES;
    hopper::mbar_expect_tx(&full[s], 2 * T::BYTES);
    tma_tile<HD>(Qs + s * T::BYTES, &qmap, &full[s], (iq0 + t) * TILE, bh);
    tma_tile<HD>(dOs + s * T::BYTES, &domap, &full[s], (iq0 + t) * TILE, bh);
  };

  if (tid == 0) {
    hopper::mbar_init(&kvbar, 1);
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&kvbar, 2 * T::BYTES);
    tma_tile<HD>(Ks, &kmap, &kvbar, k0, bh);
    tma_tile<HD>(Vs, &vmap, &kvbar, k0, bh);
    for (int t = 0; t < min(STAGES, ntiles); ++t) load_q_tile(t);
  }
  if (tid < TILE) stats(0, Ls[0][tid], Ds[0][tid]);

  // kv rows k0 + r and k0 + r + 8 of this thread; its S^T columns (q rows)
  // 8 j + 2 tq, + 1
  const int r = warp * 16 + (lane >> 2);
  const int tq = lane & 3;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  __syncthreads();                        // tile 0's lse and delta
  hopper::mbar_wait(&kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int cur = t & 1;
    const int q0 = (iq0 + t) * TILE;
    const unsigned char* Qt = Qs + s * T::BYTES;
    const unsigned char* dOt = dOs + s * T::BYTES;
    float l_next, d_next;                 // the next tile's, stored at its end
    stats(t + 1, l_next, d_next);

    // S^T = K Q^T and dP^T = V dO^T (64 kv rows x 64 q columns), two groups
    float sacc[TILE / 2], dpacc[TILE / 2];
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) sacc[i] = dpacc[i] = 0.f;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<0>(sacc, kmajor<HD>(Ks, kk), kmajor<HD>(Qt, kk));
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<0>(dpacc, kmajor<HD>(Vs, kk), kmajor<HD>(dOt, kk));
    hopper::wgmma_commit();

    // p^T while dP^T runs; masks only on tiles at an edge or the diagonal
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sacc);
    const bool masked = k0 + TILE > Sk || q0 + TILE > Sq ||
                        (causal && q0 < k0 + TILE - 1);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&Ls[cur][8 * j + 2 * tq]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kv = k0 + r + (i >> 1) * 8;
        const int qq = q0 + 8 * j + 2 * tq + (i & 1);
        const bool keep = !masked || (kv < Sk && qq < Sq && (!causal || qq >= kv));
        sacc[4 * j + i] =
            keep ? exp2_ftz(sacc[4 * j + i] * scale_log2 - ((i & 1) ? l2.y : l2.x)) : 0.f;
      }
    }

    // dV += p^T dO (dO read MN-major), and dS^T = p^T (dP^T - delta) while it
    // runs; then dK += dS^T Q
    uint32_t pa[TILE / 16][4], da[TILE / 16][4];
    to_frags<TILE>(pa, sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      hopper::wgmma_rs<1>(dva, pa[kk], mnmajor<HD>(dOt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(dpacc);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(&Ds[cur][8 * j + 2 * tq]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dpacc[4 * j + i] = sacc[4 * j + i] * (dpacc[4 * j + i] - ((i & 1) ? d2.y : d2.x));
    }
    to_frags<TILE>(da, dpacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      hopper::wgmma_rs<1>(dka, da[kk], mnmajor<HD>(Qt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_frags(pa);
    hopper::fence_frags(da);

    // every warp is done with stage s and with tile t's lse and delta: the
    // next tile's go in, and stage s takes tile t + STAGES
    if (tid < TILE) {
      Ls[cur ^ 1][tid] = l_next;
      Ds[cur ^ 1][tid] = d_next;
    }
    __syncthreads();
    if (tid == 0 && t + STAGES < ntiles) load_q_tile(t + STAGES);
  }

  const size_t row0 = static_cast<size_t>(bh) * Sk + k0;
  store_rows<HD>(dk + row0 * HD, dka, r, tq, Sk - k0, scale);
  store_rows<HD>(dv + row0 * HD, dva, r, tq, Sk - k0, 1.f);
}

// dq. The same maps.
template <int HD>
__global__ void __launch_bounds__(WT, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int BH, int Sq, int Sk,
                          int causal, float scale_log2, float scale) {
  using T = BwdTile<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[STAGES];
  unsigned char* Qs = hopper::align1024(smem_raw);
  unsigned char* dOs = Qs + T::BYTES;
  unsigned char* Ks = dOs + T::BYTES;               // stage s at s * BYTES
  unsigned char* Vs = Ks + STAGES * T::BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nq = (Sq + TILE - 1) / TILE;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * TILE;
  int nkv = (Sk + TILE - 1) / TILE;
  if (causal) nkv = min(nkv, (q0 + TILE - 1) / TILE + 1);   // to the diagonal
  auto load_kv_tile = [&](int t) {   // K and V tile t into stage t % STAGES
    const int s = t % STAGES;
    hopper::mbar_expect_tx(&full[s], 2 * T::BYTES);
    tma_tile<HD>(Ks + s * T::BYTES, &kmap, &full[s], t * TILE, bh);
    tma_tile<HD>(Vs + s * T::BYTES, &vmap, &full[s], t * TILE, bh);
  };

  if (tid == 0) {
    hopper::mbar_init(&qbar, 1);
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&qbar, 2 * T::BYTES);
    tma_tile<HD>(Qs, &qmap, &qbar, q0, bh);
    tma_tile<HD>(dOs, &domap, &qbar, q0, bh);
    for (int t = 0; t < min(STAGES, nkv); ++t) load_kv_tile(t);
  }

  // q rows q0 + r and q0 + r + 8 of this thread
  const int r = warp * 16 + (lane >> 2);
  const int tq = lane & 3;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    const size_t at = static_cast<size_t>(bh) * Sq + row;
    lse_r[h] = row < Sq ? lse[at] * LOG2E : 0.f;
    delta_r[h] = row < Sq ? delta[at] : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  hopper::mbar_wait(&qbar, 0);
  for (int t = 0; t < nkv; ++t) {
    const int s = t % STAGES;
    const int k0 = t * TILE;
    const unsigned char* Kt = Ks + s * T::BYTES;
    const unsigned char* Vt = Vs + s * T::BYTES;

    // S = Q K^T and dP = dO V^T (64 q rows x 64 kv columns), two groups
    float sacc[TILE / 2], dpacc[TILE / 2];
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) sacc[i] = dpacc[i] = 0.f;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<0>(sacc, kmajor<HD>(Qs, kk), kmajor<HD>(Kt, kk));
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<0>(dpacc, kmajor<HD>(dOs, kk), kmajor<HD>(Vt, kk));
    hopper::wgmma_commit();

    // p while dP runs, then dS = p (dP - delta) in place of dP
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sacc);
    const bool masked = k0 + TILE > Sk || q0 + TILE > Sq ||
                        (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = q0 + r + (i >> 1) * 8;
        const int kv = k0 + 8 * j + 2 * tq + (i & 1);
        const bool keep = !masked || (qq < Sq && kv < Sk && (!causal || qq >= kv));
        sacc[4 * j + i] =
            keep ? exp2_ftz(sacc[4 * j + i] * scale_log2 - lse_r[i >> 1]) : 0.f;
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpacc);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i)
      dpacc[i] = sacc[i] * (dpacc[i] - delta_r[(i >> 1) & 1]);

    // dQ += dS K: K read MN-major
    uint32_t da[TILE / 16][4];
    to_frags<TILE>(da, dpacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      hopper::wgmma_rs<1>(dqa, da[kk], mnmajor<HD>(Kt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqa);
    hopper::fence_frags(da);

    // every warp is done with stage s: it takes tile t + STAGES
    __syncthreads();
    if (tid == 0 && t + STAGES < nkv) load_kv_tile(t + STAGES);
  }

  store_rows<HD>(dq + (static_cast<size_t>(bh) * Sq + q0) * HD, dqa, r, tq,
                 Sq - q0, scale);
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

// TMA maps of q, k, v, dout, (HD, S, BH) with boxes of (BOX, TILE, 1).
template <int HD>
cudaError_t bwd_maps(const Args& a, CUtensorMap (&m)[4]) {
  using T = BwdTile<HD>;
  const uint64_t qdims[3] = {HD, static_cast<uint64_t>(a.Sq), static_cast<uint64_t>(a.BH)};
  const uint64_t kdims[3] = {HD, static_cast<uint64_t>(a.Sk), static_cast<uint64_t>(a.BH)};
  const uint64_t qstr[2] = {HD, static_cast<uint64_t>(a.Sq) * HD};
  const uint64_t kstr[2] = {HD, static_cast<uint64_t>(a.Sk) * HD};
  const uint32_t box[3] = {T::BOX, TILE, 1};
  cudaError_t err;
  if ((err = hopper::make_map(&m[0], a.q, 3, qdims, qstr, box)) != cudaSuccess ||
      (err = hopper::make_map(&m[1], a.k, 3, kdims, kstr, box)) != cudaSuccess ||
      (err = hopper::make_map(&m[2], a.v, 3, kdims, kstr, box)) != cudaSuccess)
    return err;
  return hopper::make_map(&m[3], a.dout, 3, qdims, qstr, box);
}

// Either bf16 kernel: a block per (bh, 64-row tile), of k for dkdv, of q
// for dq.
template <int HD, bool DKDV>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using T = BwdTile<HD>;
  const long long blocks = static_cast<long long>(((DKDV ? a.Sk : a.Sq) + TILE - 1) / TILE) *
                           static_cast<long long>(a.BH);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  CUtensorMap m[4];
  cudaError_t err = bwd_maps<HD>(a, m);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o1 = static_cast<__nv_bfloat16*>(a.o1);
  const dim3 grid(static_cast<unsigned>(blocks));
  static int allowed[hopper::MAX_DEVICES] = {};   // this kernel's, by device
  if constexpr (DKDV) {
    auto kern = flash_bwd_dkdv_wgmma_kernel<HD>;
    if ((err = hopper::allow_smem(kern, T::SMEM, allowed)) != cudaSuccess) return err;
    kern<<<grid, dim3(WT), T::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, o1, static_cast<__nv_bfloat16*>(a.o2),
        a.BH, a.Sq, a.Sk, a.causal, a.scale * LOG2E, a.scale);
  } else {
    auto kern = flash_bwd_dq_wgmma_kernel<HD>;
    if ((err = hopper::allow_smem(kern, T::SMEM, allowed)) != cudaSuccess) return err;
    kern<<<grid, dim3(WT), T::SMEM, stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                                                o1, a.BH, a.Sq, a.Sk, a.causal,
                                                a.scale * LOG2E, a.scale);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dkdv_hd(int dtype, Args a, cudaStream_t stream) {
  if (dtype == 1) return launch_wgmma<HD, true>(a, stream);
  const long long tiles = (a.Sk + BK - 1) / BK;
  void* args[] = {&a.q, &a.k, &a.v, &a.dout, &a.lse, &a.delta, &a.o1, &a.o2,
                  &a.BH, &a.Sq, &a.Sk, &a.causal, &a.scale};
  constexpr size_t smem = (2 * BK * (HD + 4) + 2 * BQ * (HD + 4) + 2 * BK * PP +
                           2 * BQ) * sizeof(float);
  return launch_grid(bwd_dkdv_kernel<HD>, smem, NT, tiles, a.BH, stream, args);
}

template <int HD>
cudaError_t dq_hd(int dtype, Args a, cudaStream_t stream) {
  if (dtype == 1) return launch_wgmma<HD, false>(a, stream);
  const long long tiles = (a.Sq + BQ - 1) / BQ;
  void* args[] = {&a.q, &a.k, &a.v, &a.dout, &a.lse, &a.delta, &a.o1,
                  &a.BH, &a.Sq, &a.Sk, &a.causal, &a.scale};
  constexpr size_t smem = (2 * BQ * (HD + 4) + 2 * BK * (HD + 4) + BQ * PP) *
                          sizeof(float);
  return launch_grid(bwd_dq_kernel<HD>, smem, NT, tiles, a.BH, stream, args);
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
    BWD_CASE(96)
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
