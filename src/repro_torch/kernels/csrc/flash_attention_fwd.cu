// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention.py::flash_attention_fwd (body _flash_kernel).
//
// Computes O = softmax(Q K^T * scale + mask) V over (BH, S, hd) by online
// softmax: running row max m, row sum l and an fp32 accumulator, the mask
// value NEG_INF = -1e30 kept finite, the result acc / max(l, 1e-30).
//
// What differs from the TPU kernel. There the grid's innermost KV axis runs in
// order on one core and m / l / acc live in VMEM scratch between grid steps.
// Here thread blocks run in parallel and share nothing, so one block owns one
// (bh, 64-row query tile) and walks the 64-row KV tiles in a loop of its own,
// with m, l and acc in registers. KV tiles wholly above the diagonal are never
// visited. The ragged edge (S not a multiple of 64) is masked here: rows past
// Sq load as zero and are not stored, columns past Sk score NEG_INF.
//
// What bounds it. At the serving path's shapes (hd = 128, S up to 1024) the
// function needs 4*BH*S*hd*itemsize bytes and about 2*BH*S^2*hd operations
// when causal: bytes and operations bound it about equally in bf16, and
// operations alone in fp32 (67 TFLOP/s outside the tensor cores). What the
// design does about it, one kernel per input type:
//
//  * bf16 — flash_fwd_mma_kernel: both products on the tensor cores
//    (mma.sync m16n8k16, fp32 accumulate). Scores, probabilities and output
//    stay in accumulator registers; only Q, K and V^T tiles touch shared
//    memory. Probabilities are rounded to bf16 for the second product.
//  * fp32 — flash_fwd_kernel: fp32 FMA on the CUDA cores, so the products are
//    exact fp32 (no TF32). Each thread keeps a 4x4 tile of scores and a
//    4 x hd/16 tile of the output in registers so every shared-memory load
//    feeds 4 or more FMAs; K and V share one staging buffer so that two
//    blocks fit on an SM and one computes while the other loads.
//
// Both schedule the heaviest (last) query tiles first. Neither overlaps its
// loads with its products inside a block (no cp.async / TMA ring yet) and
// neither uses wgmma; that is the next step and keeps this interface.
//
// Inputs fp32 or bf16, head dim 16, 32, 64 or 128, output in the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int BN = 64;           // kv rows per tile
constexpr int TX = 16;           // threads across score columns
constexpr int TY = 16;           // threads across query rows
constexpr int NT = TX * TY;      // 256 threads
constexpr int RPT = BM / TY;     // query rows per thread
constexpr int CPT = BN / TX;     // score columns per thread
constexpr int PP = BN + 4;       // pitch of the probability tile
constexpr float NEG_INF = -1e30f;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PER_VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// Copy up to 64 rows of hd elements from device memory into an fp32 tile in
// shared memory (pitch hd + 4), 16 bytes a thread; rows past rows_valid are
// zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int rows_valid, float mul) {
  constexpr int EPV = Elem<T>::PER_VEC;
  constexpr int VPR = HD / EPV;
  constexpr int PITCH = HD + 4;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += NT) {
    const int r = idx / VPR;
    const int cv = idx - r * VPR;
    float f[EPV];
    if (r < rows_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r) * HD + cv * EPV);
      Elem<T>::unpack(raw, f);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] = 0.f;
    }
    float* d = dst + r * PITCH + cv * EPV;
#pragma unroll
    for (int e = 0; e < EPV; e += 4) {
      *reinterpret_cast<float4*>(d + e) = make_float4(
          f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_tile(T* dst, const float* src,
                                           int rows_valid) {
  constexpr int EPV = Elem<T>::PER_VEC;
  constexpr int VPR = HD / EPV;
  constexpr int PITCH = HD + 4;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += NT) {
    const int r = idx / VPR;
    const int cv = idx - r * VPR;
    if (r >= rows_valid) continue;
    float f[EPV];
    const float* s = src + r * PITCH + cv * EPV;
#pragma unroll
    for (int e = 0; e < EPV; ++e) f[e] = s[e];
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * HD + cv * EPV) =
        Elem<T>::pack(f);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int BH, int Sq,
                 int Sk, int causal, float scale) {
  constexpr int PITCH = HD + 4;
  constexpr int VEC = (HD % 64 == 0) ? 4 : 1;  // output columns per load
  constexpr int NV = HD / (TX * VEC);          // such loads per thread
  constexpr int OC = NV * VEC;                 // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // (BM, PITCH), scaled queries, then out
  float* KVs = Qs + BM * PITCH;      // (BN, PITCH), K then V of one tile
  float* Ps = KVs + BN * PITCH;      // (BM, PP), probabilities of one tile

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nq = (Sq + BM - 1) / BM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * BM;
  const int q_valid = min(BM, Sq - q0);

  const T* qb = q + (static_cast<size_t>(bh) * Sq + q0) * HD;
  const T* kb = k + static_cast<size_t>(bh) * Sk * HD;
  const T* vb = v + static_cast<size_t>(bh) * Sk * HD;
  T* ob = o + (static_cast<size_t>(bh) * Sq + q0) * HD;

  load_tile<T, HD>(Qs, qb, q_valid, scale);

  float m[RPT], l[RPT], acc[RPT][OC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int nkv = (Sk + BN - 1) / BN;
  if (causal) nkv = min(nkv, (q0 + BM - 1) / BN + 1);

  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * BN;
    const int k_valid = min(BN, Sk - k0);

    __syncthreads();  // the previous tile's V is no longer read
    load_tile<T, HD>(KVs, kb + static_cast<size_t>(k0) * HD, k_valid, 1.f);
    __syncthreads();

    // scores: s[i][j] = sum_d Q[ty*RPT+i][d] * K[tx+TX*j][d]
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        b[j] = *reinterpret_cast<const float4*>(KVs + (tx + TX * j) * PITCH + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update; the 16 threads that share a row
    // are the 16 lanes of one half-warp, so xor-shuffles below 16 stay inside
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + TX * j;
        const bool keep = (col < Sk) && (!causal || row >= col);
        if (!keep) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * RPT + i) * PP + tx + TX * j] = p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // K is no longer read
    load_tile<T, HD>(KVs, vb + static_cast<size_t>(k0) * HD, k_valid, 1.f);
    __syncthreads();  // V and the probabilities are visible

    // acc[i][c] += sum_kk P[ty*RPT+i][kk] * V[kk][col(c)]
#pragma unroll 2
    for (int kk = 0; kk < BN; kk += 4) {
      float p[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * RPT + i) * PP + kk);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = KVs + (kk + u) * PITCH;
#pragma unroll
        for (int jv = 0; jv < NV; ++jv) {
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vrow + (tx + TX * jv) * 4);
            vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
          } else {
            vv[0] = vrow[tx + TX * jv];
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][jv * VEC + e] = fmaf(p[i][u], vv[e], acc[i][jv * VEC + e]);
        }
      }
    }
  }

  // normalise, stage the tile through shared memory, store 16 bytes a thread
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jv = 0; jv < NV; ++jv)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        Qs[(ty * RPT + i) * PITCH + (tx + TX * jv) * VEC + e] =
            acc[i][jv * VEC + e] / denom;
  }
  __syncthreads();
  store_tile<T, HD>(ob, Qs, q_valid);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH,
                   int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem_bytes =
      (BM * (HD + 4) + BN * (HD + 4) + BM * PP) * sizeof(float);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sq + BM - 1) / BM) * static_cast<long long>(BH);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(static_cast<unsigned>(blocks)), dim3(NT), smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: the two products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate). One block is 4 warps and owns 64 query rows, 16
// a warp; scores, probabilities and the output tile stay in the accumulator
// registers of the warp that owns the rows, so the softmax needs shuffles
// inside a quad only and nothing but Q, K and V^T ever sits in shared memory.
// V is stored transposed so that both products read their B operand as
// aligned 32-bit pairs, free of bank conflicts (pitch = width + 8).
// ---------------------------------------------------------------------------
constexpr int MT = 128;  // threads of the tensor-core kernel

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows of HD bf16 from device memory into a tile of pitch HD + 8, 16 bytes
// a thread; rows past rows_valid are zero.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int rows_valid) {
  constexpr int VPR = HD / 8;
  constexpr int PITCH = HD + 8;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += MT) {
    const int r = idx / VPR;
    const int cv = idx - r * VPR;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + cv * 8);
    *reinterpret_cast<uint4*>(dst + r * PITCH + cv * 8) = raw;
  }
}

// The same rows, stored transposed: dst[col][row], pitch 64 + 8. Neighbouring
// threads take neighbouring rows so that the 16-bit stores do not collide.
template <int HD>
__device__ __forceinline__ void load_tile_bf16_transposed(
    __nv_bfloat16* dst, const __nv_bfloat16* src, int rows_valid) {
  constexpr int VPR = HD / 8;
  constexpr int PITCH = 64 + 8;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += MT) {
    const int r = idx % 64;
    const int cv = idx / 64;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + cv * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(cv * 8 + i) * PITCH + r] = e[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int BH, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int QP = HD + 8;   // pitch of the Q and K tiles
  constexpr int VP = BN + 8;   // pitch of the transposed V tile
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NS = BN / 8;   // 8-wide column tiles of the scores
  constexpr int ON = HD / 8;   // 8-wide column tiles of the output
  constexpr int KT = BN / 16;  // k-steps of P V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BM, QP)
  __nv_bfloat16* Ks = Qs + BM * QP;                                // (BN, QP)
  __nv_bfloat16* Vt = Ks + BN * QP;                                // (HD, VP)

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int g = lane >> 2;                 // row within 8 (and B column)
  const int tig = lane & 3;                // thread in the quad
  const int nq = (Sq + BM - 1) / BM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * BM;
  const int q_valid = min(BM, Sq - q0);

  const __nv_bfloat16* qb = q + (static_cast<size_t>(bh) * Sq + q0) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * Sk * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * Sk * HD;
  __nv_bfloat16* ob = o + (static_cast<size_t>(bh) * Sq + q0) * HD;

  load_tile_bf16<HD>(Qs, qb, q_valid);

  // each thread owns rows r0+g (half 0) and r0+g+8 (half 1) of its warp
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float oacc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[n][c] = 0.f;

  int nkv = (Sk + BN - 1) / BN;
  if (causal) nkv = min(nkv, (q0 + BM - 1) / BN + 1);

  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * BN;
    const int k_valid = min(BN, Sk - k0);

    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_bf16<HD>(Ks, kb + static_cast<size_t>(k0) * HD, k_valid);
    load_tile_bf16_transposed<HD>(Vt, vb + static_cast<size_t>(k0) * HD, k_valid);
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* qa = Qs + (r0 + g) * QP + ks * 16 + 2 * tig;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * QP), ld32(qa + 8),
                             ld32(qa + 8 * QP + 8)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * QP + ks * 16 + 2 * tig;
        mma_bf16_m16n8k16(s[n], a, ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, online softmax; a row's 16 values of one thread and the
    // other three threads of its quad make up the row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + r0 + g + (c >> 1) * 8;
        const int col = k0 + n * 8 + 2 * tig + (c & 1);
        const bool keep = (col < Sk) && (!causal || row >= col);
        s[n][c] = keep ? s[n][c] * scale : NEG_INF;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m[c >> 1]);
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) oacc[n][c] *= corr[c >> 1];

    // out += P V: the score accumulators of two neighbouring column tiles
    // are, rounded to bf16, exactly the A operand of one k-step
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        const __nv_bfloat16* vp = Vt + (n * 8 + g) * VP + kt * 16 + 2 * tig;
        mma_bf16_m16n8k16(oacc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // normalise; a warp writes its own 16 rows of the Q tile, which no other
  // warp reads, then the block stores the tile 16 bytes a thread
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    __nv_bfloat16* dst = Qs + (r0 + g) * QP + n * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(dst) =
        pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(dst + 8 * QP) =
        pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncthreads();
  constexpr int VPR = HD / 8;
  for (int idx = threadIdx.x; idx < BM * VPR; idx += MT) {
    const int r = idx / VPR;
    const int cv = idx - r * VPR;
    if (r < q_valid)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * HD + cv * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * QP + cv * 8);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int BH, int Sq, int Sk, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem_bytes =
      (BM * (HD + 8) + BN * (HD + 8) + HD * (BN + 8)) * sizeof(__nv_bfloat16);
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sq + BM - 1) / BM) * static_cast<long long>(BH);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  using bf16 = __nv_bfloat16;
  kern<<<dim3(static_cast<unsigned>(blocks)), dim3(MT), smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), BH, Sq, Sk, causal,
      scale);
  return cudaGetLastError();
}

// fp32 inputs take the FMA kernel (exact fp32 products), bf16 inputs the
// tensor-core kernel.
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int BH, int Sq, int Sk, int causal,
                        float scale, cudaStream_t stream) {
#define FLASH_CASE(HD_)                                                        \
  case HD_:                                                                    \
    if constexpr (sizeof(T) == 2)                                              \
      return launch_mma<HD_>(q, k, v, o, BH, Sq, Sk, causal, scale, stream);   \
    else                                                                       \
      return launch<T, HD_>(q, k, v, o, BH, Sq, Sk, causal, scale, stream);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous (BH, S, hd).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Sq, int Sk, int hd,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_hd<float>(hd, q, k, v, o, BH, Sq, Sk, causal, scale, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, Sq, Sk, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
