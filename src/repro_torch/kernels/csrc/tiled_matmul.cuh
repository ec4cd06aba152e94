// Tiled matrix products for Hopper (sm_90a), shared by stream_matmul.cu and
// grouped_matmul.cu.
//
// out[b] = x[b] @ w[b] for a batch of independent products (b = blockIdx.z:
// one for stream_matmul, the experts for grouped_matmul), an fp32
// accumulator, K innermost, the result in x's type. Each operand carries its
// own batch stride, so a batch may share one x (stride 0: the MoE decode,
// where every expert reads the same rows) and w may be any (K, N) ("kn") or
// (N, K) ("nk") row-major slab. Any M, N, K: ragged edges are masked.
//
// Three kernels; the caller's plan (grouped_matmul.py::plan,
// stream_matmul.py::plan) names one per call, and launch_planned runs it:
//
//  * wgmma_mm_kernel (bf16 x, bf16 w, TMA-aligned operands): a ring of
//    WSTAGES stages in shared memory, each a 64-deep slice of K of the x
//    tile and the w tile, loaded by TMA from one producer warp and guarded
//    by a full and an empty mbarrier; one or two consumer warpgroups run
//    wgmma m64nBNk16 (fp32 accumulate) on each stage as it lands, so the
//    loads of the next stages are in flight while the tensor cores work. x
//    is the K-major A operand; w is read as it lies: "kn" is an MN-major B
//    (the transpose bit), "nk" a K-major one. A shared x is read through a
//    2-D map of the one (M, K) buffer. Tiles: 64 x 64 with one consumer
//    warpgroup when M <= 64 (a decode: bound by the bytes of w, so narrow
//    tiles give the most blocks, each with four 16 KB stages in flight),
//    128 x 128 with two when M > 64 (a prefill: the w tile feeds both).
//  * tiled_mm_mma_kernel (bf16 x otherwise: w in fp32, or an operand TMA
//    cannot describe: a base not 16-byte aligned or a stride that is not a
//    multiple of 8 elements): mma.sync m16n8k16, 64 x 128 output tiles, four
//    warps of 32 x 64, tiles loaded into shared memory with plain loads
//    (each w tile converted to x's type after loading, as the reference
//    casts w before the product).
//  * tiled_mm_fma_kernel (fp32 x): true fp32 FMA on the CUDA cores (no TF32:
//    the reference holds fp32 to 1e-5), 64 x 64 tiles, 4 x 4 outputs a
//    thread. Its summation order is what holds fp32 tokens equal between a
//    resident and a streamed expert stack.
//
// No route splits K across blocks or uses atomics: every output is summed in
// one fixed order, and two runs on the same inputs give the same bits.
//
// A product can be one panel of a longer K: accumulate adds the fp32
// partial sum of the earlier panels (acc), finish writes the output in x's
// type instead of the next partial sum.
//
// Each kernel takes a tag type, Route, naming its caller and where w lives
// (stream_resident, stream_pinned, gmm_resident, gmm_pinned: declared by the
// two sources). It changes no code; it only gives every route its own
// kernel name, so that a profile tells the routes apart, e.g.
// wgmma_mm_kernel<gmm_pinned, 1, 64, 0>.
//
// stream_panels is the pipeline of both copy-engine routes: panels of a
// pinned w cross the host link into a two-slot device ring on a side stream
// while the caller's stream multiplies the panel before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// element access and tile loads
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TS, typename TD>
__device__ __forceinline__ TD convert(TS v) {
  return from_f32<TD>(to_f32(v));
}
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return v;
}
template <>
__device__ __forceinline__ float convert<float, float>(float v) {
  return v;
}

// Copy a ROWS x COLS tile of a row-major source (leading dimension ld, only
// rows_valid x cols_valid of it inside the matrix; the rest reads as zero)
// into shared memory, converted to TD: dst[r * pitch + c], or dst[c * pitch
// + r] when trans. Each thread moves runs of V = 16 / sizeof(TS) neighbouring
// source elements, one 16-byte load when vec says the source is aligned for
// it and the run lies inside the matrix, element by element otherwise.
template <typename TS, typename TD, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(TD* __restrict__ dst, int pitch,
                                          bool trans,
                                          const TS* __restrict__ src,
                                          long long ld, int rows_valid,
                                          int cols_valid, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(TS));
  constexpr int RUNS = COLS / V;
  static_assert(COLS % V == 0, "tile width must hold whole runs");
  for (int idx = threadIdx.x; idx < ROWS * RUNS; idx += NTHREADS) {
    const int r = idx / RUNS;
    const int c0 = (idx - r * RUNS) * V;
    alignas(16) TS e[V];
    const TS* s = src + static_cast<long long>(r) * ld + c0;
    if (vec && r < rows_valid && c0 + V <= cols_valid) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        e[i] = (r < rows_valid && c0 + i < cols_valid) ? s[i] : from_f32<TS>(0.f);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = c0 + i;
      dst[trans ? c * pitch + r : r * pitch + c] = convert<TS, TD>(e[i]);
    }
  }
}

// The epilogue of both kernels: one output element, added to the fp32
// partial sum of the earlier panels when accumulate, then written either as
// the next partial sum (fp32) or, on the last panel, as the output in TX.
template <typename TX>
__device__ __forceinline__ void emit(float v, int row, int col, int M, int N,
                                     float* __restrict__ acc,
                                     TX* __restrict__ out, int accumulate,
                                     int finish) {
  if (row >= M || col >= N) return;
  const long long i = static_cast<long long>(row) * N + col;
  if (accumulate) v += acc[i];
  if (finish)
    out[i] = from_f32<TX>(v);
  else
    acc[i] = v;
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------
constexpr int TBM = 64;             // output rows per block
constexpr int TBN = 128;            // output columns per block
constexpr int TBK = 32;             // depth of one shared-memory step
constexpr int TP = TBK + 8;         // pitch of both tiles (bf16 elements)
constexpr int TT = 128;             // threads: 4 warps, 2 x 2, each 32 x 64

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x: (M, K) bf16, leading dimension ldx. w: "kn" (K, N) or "nk" (N, K) in
// TW, leading dimension ldw. Product b of the batch starts at x + b * sxb,
// w + b * swb, and writes the dense (M, N) block b of out and acc. Both
// tiles sit in shared memory k-contiguous (As[m][k], Bs[n][k]), the layout
// the row.col mma reads as aligned pairs.
template <typename Route, typename TW>
__global__ void __launch_bounds__(TT)
tiled_mm_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                    long long sxb, const TW* __restrict__ w, long long ldw,
                    long long swb, int w_nk, float* __restrict__ acc,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K,
                    int accumulate, int finish, int vec_x, int vec_w) {
  __shared__ __align__(16) __nv_bfloat16 As[TBM * TP];
  __shared__ __align__(16) __nv_bfloat16 Bs[TBN * TP];

  const long long b = blockIdx.z;
  x += b * sxb;
  w += b * swb;
  out += b * M * N;
  if (acc != nullptr) acc += b * M * N;
  const int n0 = blockIdx.x * TBN;
  const int m0 = blockIdx.y * TBM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;   // this warp's rows in the tile
  const int wn = (warp & 1) * 64;    // and columns
  const int g = lane >> 2;
  const int tig = lane & 3;

  float c[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  const __nv_bfloat16* xb = x + static_cast<long long>(m0) * ldx;
  for (int k0 = 0; k0 < K; k0 += TBK) {
    const int kv = min(TBK, K - k0);
    __syncthreads();   // the previous step's tiles are no longer read
    load_tile<__nv_bfloat16, __nv_bfloat16, TBM, TBK, TT>(
        As, TP, false, xb + k0, ldx, M - m0, kv, vec_x);
    if (w_nk)
      load_tile<TW, __nv_bfloat16, TBN, TBK, TT>(
          Bs, TP, false, w + static_cast<long long>(n0) * ldw + k0, ldw,
          N - n0, kv, vec_w);
    else
      load_tile<TW, __nv_bfloat16, TBK, TBN, TT>(
          Bs, TP, true, w + static_cast<long long>(k0) * ldw + n0, ldw, kv,
          N - n0, vec_w);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* ap = As + (wm + i * 16 + g) * TP + ks + 2 * tig;
        a[i][0] = ld32(ap);
        a[i][1] = ld32(ap + 8 * TP);
        a[i][2] = ld32(ap + 8);
        a[i][3] = ld32(ap + 8 * TP + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = Bs + (wn + j * 8 + g) * TP + ks + 2 * tig;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
        mma_bf16_m16n8k16(c[0][j], a[0], b0, b1);
        mma_bf16_m16n8k16(c[1][j], a[1], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + j * 8 + 2 * tig + (e & 1);
        emit(c[i][j][e], row, col, M, N, acc, out, accumulate, finish);
      }
}

// ---------------------------------------------------------------------------
// fp32 x: exact fp32 FMA on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FT = 256;   // 16 x 16 threads, each rows ty + 16 i, cols tx + 16 j

// Tiles k-major in shared memory (As[k][m], Bs[k][n]): a thread's four rows
// are one broadcast each, its four columns one conflict-free load each.
template <typename Route, typename TW>
__global__ void __launch_bounds__(FT)
tiled_mm_fma_kernel(const float* __restrict__ x, long long ldx, long long sxb,
                    const TW* __restrict__ w, long long ldw, long long swb,
                    int w_nk, float* __restrict__ acc, float* __restrict__ out,
                    int M, int N, int K, int accumulate, int finish, int vec_x,
                    int vec_w) {
  __shared__ __align__(16) float As[FBK * (FBM + 4)];
  __shared__ __align__(16) float Bs[FBK * (FBN + 4)];
  constexpr int AP = FBM + 4;
  constexpr int BP = FBN + 4;

  const long long b = blockIdx.z;
  x += b * sxb;
  w += b * swb;
  out += b * M * N;
  if (acc != nullptr) acc += b * M * N;
  const int n0 = blockIdx.x * FBN;
  const int m0 = blockIdx.y * FBM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

  const float* xb = x + static_cast<long long>(m0) * ldx;
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const int kv = min(FBK, K - k0);
    __syncthreads();
    load_tile<float, float, FBM, FBK, FT>(As, AP, true, xb + k0, ldx, M - m0,
                                          kv, vec_x);
    if (w_nk)
      load_tile<TW, float, FBN, FBK, FT>(
          Bs, BP, true, w + static_cast<long long>(n0) * ldw + k0, ldw,
          N - n0, kv, vec_w);
    else
      load_tile<TW, float, FBK, FBN, FT>(
          Bs, BP, false, w + static_cast<long long>(k0) * ldw + n0, ldw, kv,
          N - n0, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * AP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * BP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(c[i][j], m0 + ty + 16 * i, n0 + tx + 16 * j, M, N, acc, out,
           accumulate, finish);
}

// ---------------------------------------------------------------------------
// bf16 x and w, TMA-aligned: wgmma on a TMA-fed ring of stages
// ---------------------------------------------------------------------------
constexpr int WBK = 64;       // K depth of a stage: one 128-byte swizzle row
constexpr int WSTAGES = 4;    // stages in the ring

template <int WG, int BN>
struct WgmmaTile {
  static constexpr int BM = 64 * WG;                 // one warpgroup a 64 rows
  static constexpr int A_BYTES = BM * WBK * 2;       // x: BM rows of 128 B
  static constexpr int B_BYTES = BN * WBK * 2;       // w: BN/64 chunks (kn) or BN rows (nk)
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * WG + 32;      // + the producer warp
  static constexpr int SMEM = WSTAGES * STAGE + 1024;  // + slack to align to 1 KB
};

// Two neighbouring outputs of one row: one 4-byte store when they can be
// written as the output type straight away, else emit() each.
__device__ __forceinline__ void emit2(float v0, float v1, int row, int col,
                                      int M, int N, float* __restrict__ acc,
                                      __nv_bfloat16* __restrict__ out,
                                      int accumulate, int finish) {
  if (row >= M) return;
  if (!accumulate && finish && col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * N + col) =
        __floats2bfloat162_rn(v0, v1);
    return;
  }
  emit(v0, row, col, M, N, acc, out, accumulate, finish);
  emit(v1, row, col + 1, M, N, acc, out, accumulate, finish);
}

// xmap: (K, M) of a shared x (x_shared), else (K, M, batch); box (64, BM[, 1]).
// X_T = 1: x is given as its transpose, (M, K, batch) with M innermost (the
// backward's x^T of an (E, C, d) buffer, read as it lies), box (64, 64, 1),
// BM / 64 boxes a stage, an MN-major A (A's transpose bit), as "kn" w is an
// MN-major B.
// wmap: "kn" (N, K, batch), box (64, 64, 1), BN / 64 boxes a stage; "nk"
// (K, N, batch), box (64, BN, 1). All bf16, 128-byte swizzle.
template <typename Route, int WG, int BN, int W_NK, int X_T = 0>
__global__ void __launch_bounds__(WgmmaTile<WG, BN>::THREADS)
wgmma_mm_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, int x_shared,
                float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                int M, int N, int K, int accumulate, int finish) {
  using T = WgmmaTile<WG, BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WSTAGES], empty[WSTAGES];
  unsigned char* smem = hopper::align1024(smem_raw);

  const int b = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * T::BM;
  const int nk = (K + WBK - 1) / WBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * WG);   // lane 0 of every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * WG) {
    // producer: stage kt % WSTAGES is refilled once the consumers released
    // its previous use, kt - WSTAGES
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WSTAGES;
        if (kt >= WSTAGES) hopper::mbar_wait(&empty[s], ((kt / WSTAGES) - 1) & 1);
        unsigned char* a = smem + s * T::STAGE;
        unsigned char* bt = a + T::A_BYTES;
        hopper::mbar_expect_tx(&full[s], T::STAGE);
        if (X_T) {
#pragma unroll
          for (int c = 0; c < WG; ++c)
            hopper::tma_load_3d(a + c * 64 * WBK * 2, &xmap, &full[s],
                                m0 + 64 * c, kt * WBK, b);
        } else if (x_shared) {
          hopper::tma_load_2d(a, &xmap, &full[s], kt * WBK, m0);
        } else {
          hopper::tma_load_3d(a, &xmap, &full[s], kt * WBK, m0, b);
        }
        if (W_NK) {
          hopper::tma_load_3d(bt, &wmap, &full[s], kt * WBK, n0, b);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_3d(bt + c * 64 * WBK * 2, &wmap, &full[s],
                                n0 + 64 * c, kt * WBK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WSTAGES;
    hopper::mbar_wait(&full[s], (kt / WSTAGES) & 1);
    const unsigned char* a = smem + s * T::STAGE + wg * 64 * WBK * 2;
    const unsigned char* bt = smem + s * T::STAGE + T::A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
      // A: K-major, a k-step is 32 bytes along the swizzled row; X_T:
      // MN-major like "kn" B, a k-step is 16 rows of 128 B (the warpgroup's
      // 64 rows are one 64-column chunk)
      const uint64_t da =
          X_T ? hopper::make_desc(a + kk * 16 * 128, 64 * WBK * 2, 1024, 128)
              : hopper::make_desc(a + kk * 32, 16, 1024, 128);
      // B: "nk" K-major like A; "kn" MN-major, a k-step is 16 rows of 128 B,
      // the 64-column chunks 64 * WBK * 2 bytes apart
      const uint64_t db =
          W_NK ? hopper::make_desc(bt + kk * 32, 16, 1024, 128)
               : hopper::make_desc(bt + kk * 16 * 128, 64 * WBK * 2, 1024, 128);
      hopper::wgmma_ss<W_NK ? 0 : 1, X_T>(d, da, db);
    }
    hopper::wgmma_commit();
    // the stage before this one is no longer read: hand it back
    hopper::wgmma_wait<1>();
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % WSTAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);

  out += static_cast<long long>(b) * M * N;
  if (acc != nullptr) acc += static_cast<long long>(b) * M * N;
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      emit2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], row + 8 * h, col + 8 * j, M,
            N, acc, out, accumulate, finish);
}

// ---------------------------------------------------------------------------
// launch of one batch of products (the whole K, or one panel of it)
// ---------------------------------------------------------------------------
struct Operand {
  const void* ptr;    // first element of product 0 (at this panel's k0)
  long long ld;       // row stride, elements
  long long batch;    // stride between products, elements (0: shared)
  int dtype;          // 0 = float32, 1 = bfloat16
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

size_t elem_size(int dtype) { return dtype == 1 ? 2 : 4; }

template <typename Route, typename TW>
cudaError_t launch_typed(const Operand& x, const Operand& w, int w_nk,
                         float* acc, void* out, int batch, int M, int N, int K,
                         int accumulate, int finish, cudaStream_t stream) {
  const int vw = 16 / static_cast<int>(sizeof(TW));
  const int vec_w = aligned16(w.ptr) && w.ld % vw == 0 && w.batch % vw == 0;
  if (x.dtype == 1) {
    const int vec_x = aligned16(x.ptr) && x.ld % 8 == 0 && x.batch % 8 == 0;
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, batch);
    tiled_mm_mma_kernel<Route, TW><<<grid, TT, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x.ptr), x.ld, x.batch,
        static_cast<const TW*>(w.ptr), w.ld, w.batch, w_nk, acc,
        static_cast<__nv_bfloat16*>(out), M, N, K, accumulate, finish, vec_x,
        vec_w);
  } else {
    const int vec_x = aligned16(x.ptr) && x.ld % 4 == 0 && x.batch % 4 == 0;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, batch);
    tiled_mm_fma_kernel<Route, TW><<<grid, FT, 0, stream>>>(
        static_cast<const float*>(x.ptr), x.ld, x.batch,
        static_cast<const TW*>(w.ptr), w.ld, w.batch, w_nk, acc,
        static_cast<float*>(out), M, N, K, accumulate, finish, vec_x, vec_w);
  }
  return cudaGetLastError();
}

// out (and acc) hold `batch` dense (M, N) blocks, block b for product b.
template <typename Route>
cudaError_t launch_product(const Operand& x, const Operand& w, int w_nk,
                           float* acc, void* out, int batch, int M, int N,
                           int K, int accumulate, int finish,
                           cudaStream_t stream) {
  if ((M + TBM - 1) / TBM > 65535 || batch < 1 || batch > 65535)
    return cudaErrorInvalidConfiguration;
  if (w.dtype == 1)
    return launch_typed<Route, __nv_bfloat16>(x, w, w_nk, acc, out, batch, M,
                                              N, K, accumulate, finish, stream);
  return launch_typed<Route, float>(x, w, w_nk, acc, out, batch, M, N, K,
                                    accumulate, finish, stream);
}

template <typename Route, int WG, int BN, int W_NK, int X_T = 0>
cudaError_t launch_wgmma_tile(const CUtensorMap& xmap, const CUtensorMap& wmap,
                              int x_shared, float* acc, void* out, int batch,
                              int M, int N, int K, int accumulate, int finish,
                              cudaStream_t stream) {
  using T = WgmmaTile<WG, BN>;
  auto kern = wgmma_mm_kernel<Route, WG, BN, W_NK, X_T>;
  static int allowed[hopper::MAX_DEVICES] = {};   // this kernel's, by device
  cudaError_t err = hopper::allow_smem(kern, T::SMEM, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, batch);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(xmap, wmap, x_shared, acc,
                                               static_cast<__nv_bfloat16*>(out),
                                               M, N, K, accumulate, finish);
  return cudaGetLastError();
}

// The wgmma route of a batch of bf16 products (the arguments as
// launch_product's), on a block_m x block_n output tile: 64 x 64 or
// 128 x 128. The TMA maps need 16-byte-aligned bases and strides that are
// multiples of 8 elements; an operand that is not is refused
// (cudaErrorInvalidValue), never rerouted: the caller's plan sends it to
// launch_product.
template <typename Route>
cudaError_t launch_wgmma(const Operand& x, const Operand& w, int w_nk,
                         float* acc, void* out, int batch, int M, int N, int K,
                         int accumulate, int finish, int block_m, int block_n,
                         cudaStream_t stream) {
  if (x.dtype != 1 || w.dtype != 1 || batch < 1 || batch > 65535 ||
      (M + block_m - 1) / block_m > 65535)
    return cudaErrorInvalidValue;
  const int x_shared = x.batch == 0;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M),
                             static_cast<uint64_t>(batch)};
  const uint64_t xstr[2] = {static_cast<uint64_t>(x.ld),
                            static_cast<uint64_t>(x.batch)};
  const uint32_t xbox[3] = {WBK, static_cast<uint32_t>(block_m), 1};
  cudaError_t err = hopper::make_map(&xmap, x.ptr, x_shared ? 2 : 3, xdims,
                                     xstr, xbox);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {
      static_cast<uint64_t>(w_nk ? K : N), static_cast<uint64_t>(w_nk ? N : K),
      static_cast<uint64_t>(batch)};
  const uint64_t wstr[2] = {static_cast<uint64_t>(w.ld),
                            static_cast<uint64_t>(w.batch)};
  const uint32_t wbox[3] = {WBK, static_cast<uint32_t>(w_nk ? block_n : 64), 1};
  if ((err = hopper::make_map(&wmap, w.ptr, 3, wdims, wstr, wbox)) != cudaSuccess)
    return err;
#define WGMMA_TILE(WG_, BN_)                                                    \
  if (block_m == 64 * WG_ && block_n == BN_)                                    \
    return w_nk ? launch_wgmma_tile<Route, WG_, BN_, 1>(                        \
                      xmap, wmap, x_shared, acc, out, batch, M, N, K,           \
                      accumulate, finish, stream)                               \
                : launch_wgmma_tile<Route, WG_, BN_, 0>(                        \
                      xmap, wmap, x_shared, acc, out, batch, M, N, K,           \
                      accumulate, finish, stream);
  WGMMA_TILE(1, 64)
  WGMMA_TILE(2, 128)
#undef WGMMA_TILE
  return cudaErrorInvalidValue;
}

// The wgmma route of a batch of bf16 products whose x is given transposed:
// x.ptr holds x^T, (K, M) per product with row stride x.ld and batch stride
// x.batch (not 0), M contiguous; w "kn" (K, N) on the device; the whole K
// (no accumulate), output dense. Tiles and refusals as launch_wgmma's.
template <typename Route>
cudaError_t launch_wgmma_xt(const Operand& x, const Operand& w, void* out,
                            int batch, int M, int N, int K, int block_m,
                            int block_n, cudaStream_t stream) {
  if (x.dtype != 1 || w.dtype != 1 || x.batch == 0 || batch < 1 ||
      batch > 65535 || (M + block_m - 1) / block_m > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[3] = {static_cast<uint64_t>(M), static_cast<uint64_t>(K),
                             static_cast<uint64_t>(batch)};
  const uint64_t xstr[2] = {static_cast<uint64_t>(x.ld),
                            static_cast<uint64_t>(x.batch)};
  const uint32_t xbox[3] = {64, WBK, 1};
  cudaError_t err = hopper::make_map(&xmap, x.ptr, 3, xdims, xstr, xbox);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                             static_cast<uint64_t>(batch)};
  const uint64_t wstr[2] = {static_cast<uint64_t>(w.ld),
                            static_cast<uint64_t>(w.batch)};
  const uint32_t wbox[3] = {WBK, 64, 1};
  if ((err = hopper::make_map(&wmap, w.ptr, 3, wdims, wstr, wbox)) != cudaSuccess)
    return err;
  if (block_m == 64 && block_n == 64)
    return launch_wgmma_tile<Route, 1, 64, 0, 1>(xmap, wmap, 0, nullptr, out,
                                                 batch, M, N, K, 0, 1, stream);
  if (block_m == 128 && block_n == 128)
    return launch_wgmma_tile<Route, 2, 128, 0, 1>(xmap, wmap, 0, nullptr, out,
                                                  batch, M, N, K, 0, 1, stream);
  return cudaErrorInvalidValue;
}

// One batch of products on the kernel the caller's plan named: product 1 is
// the wgmma route on a block_m x block_n tile, product 0 the tiled kernels
// (mma.sync for bf16 x, FMA for fp32 x; block_m, block_n unused).
template <typename Route>
cudaError_t launch_planned(int product, int block_m, int block_n,
                           const Operand& x, const Operand& w, int w_nk,
                           float* acc, void* out, int batch, int M, int N,
                           int K, int accumulate, int finish,
                           cudaStream_t stream) {
  if (product == 1)
    return launch_wgmma<Route>(x, w, w_nk, acc, out, batch, M, N, K,
                               accumulate, finish, block_m, block_n, stream);
  return launch_product<Route>(x, w, w_nk, acc, out, batch, M, N, K,
                               accumulate, finish, stream);
}

// ---------------------------------------------------------------------------
// the side stream and events of a host route, one set per device
// ---------------------------------------------------------------------------
using hopper::MAX_DEVICES;

struct Streamer {
  bool ready = false;
  cudaStream_t copy = nullptr;
  cudaEvent_t start = nullptr;       // the caller's stream reached the call
  cudaEvent_t copied[2] = {nullptr, nullptr};   // panel in ring slot i landed
  cudaEvent_t used[2] = {nullptr, nullptr};     // product done with slot i
};

Streamer streamers[MAX_DEVICES];

cudaError_t streamer_for(Streamer** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Streamer& s = streamers[dev];
  if (!s.ready) {
    // non-blocking: no implicit ordering against the legacy default stream,
    // which is PyTorch's default stream
    err = cudaStreamCreateWithFlags(&s.copy, cudaStreamNonBlocking);
    if (err != cudaSuccess) return err;
    cudaEvent_t* evs[5] = {&s.start, &s.copied[0], &s.copied[1], &s.used[0],
                           &s.used[1]};
    for (cudaEvent_t* e : evs) {
      err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
    }
    s.ready = true;
  }
  *out = &s;
  return cudaSuccess;
}

// The host pointer must be pinned memory, so that the copies are
// asynchronous DMA and not staged through a pageable bounce buffer.
cudaError_t require_pinned(const void* p) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) return err;
  return attr.type == cudaMemoryTypeHost ? cudaSuccess : cudaErrorInvalidValue;
}

// Streams a pinned host w through ring, two slots of slot_bytes of device
// memory, in `panels` panels. copy(j, slot, copy_stream) issues the copy of
// panel j into slot on the side stream; product(j, slot) launches panel j's
// product on the caller's stream s. Panel j + 1 crosses the link while
// panel j is multiplied; a slot is refilled only after the product that
// read it, and the first copies wait for the work s had queued before the
// call (the ring may reuse its memory). Does not synchronise.
template <typename Copy, typename Product>
cudaError_t stream_panels(const void* w, int panels, void* ring,
                          size_t slot_bytes, cudaStream_t s, Copy copy,
                          Product product) {
  cudaError_t err = require_pinned(w);
  if (err != cudaSuccess) return err;
  Streamer* st = nullptr;
  if ((err = streamer_for(&st)) != cudaSuccess) return err;
  char* slots[2] = {static_cast<char*>(ring),
                    static_cast<char*>(ring) + slot_bytes};
  auto issue = [&](int j) {
    const int slot = j & 1;
    cudaError_t e = cudaSuccess;
    if (j >= 2 && (e = cudaStreamWaitEvent(st->copy, st->used[slot], 0)) !=
                      cudaSuccess)
      return e;
    if ((e = copy(j, slots[slot], st->copy)) != cudaSuccess) return e;
    return cudaEventRecord(st->copied[slot], st->copy);
  };
  if ((err = cudaEventRecord(st->start, s)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(st->copy, st->start, 0)) != cudaSuccess)
    return err;
  if ((err = issue(0)) != cudaSuccess) return err;
  for (int j = 0; j < panels; ++j) {
    const int slot = j & 1;
    if (j + 1 < panels && (err = issue(j + 1)) != cudaSuccess) return err;
    if ((err = cudaStreamWaitEvent(s, st->copied[slot], 0)) != cudaSuccess)
      return err;
    if ((err = product(j, slots[slot])) != cudaSuccess) return err;
    if ((err = cudaEventRecord(st->used[slot], s)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
