// Streaming matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/stream_matmul.py::stream_matmul (body _stream_kernel).
//
// Computes out = x @ w over (M, K) x (K, N): an fp32 accumulator, K innermost,
// the result in x's type. w may be of another type than x; each w tile is
// converted to x's type after it is loaded, as the reference casts w before
// the product, so w's bytes cross the host link in w's own type. w is either
// (K, N) row-major ("kn") or (N, K) row-major ("nk", the tied unembedding's
// tok_embed.T), each with its own leading dimension. Any M, N, K: the
// reference's divisibility assert is a TPU tiling artefact, and a decode step
// has M = the number of slots.
//
// Two routes, one per place w lives:
//
//  * w in device memory: one launch over the whole K. Each block owns an
//    output tile and loops over K itself, the accumulator in registers
//    (on the TPU the K grid axis runs in order and the accumulator lives in
//    VMEM scratch between grid steps).
//  * w in pinned host memory: the reference's structure, for real. K-panels
//    of w (block_k rows of K, all of N) are copied by the copy engine into a
//    two-panel device ring on a side stream; the product of panel j runs on
//    the caller's stream while panel j + 1 is in flight, ordered by events,
//    and accumulates into one fp32 buffer; the last panel writes the output.
//    Every byte of w crosses the link exactly once per call, whatever M is.
//    An "nk" w is cut into the same K-panels by a 2-D copy (N rows of
//    block_k elements), so the table is never transposed on the host.
//
// What bounds it. With w on the host, the host link: K*N*sizeof(w) bytes at
// some 50 GB/s (about 2.3 ms for one 4096 x 14336 bf16 matrix), against
// which the products of a decode step (M = 4) are free and those of a
// 1024-token prefill are of the same order; the ring hides whichever is
// smaller under the other. With w on the device, HBM for small M (w read
// once) and the tensor cores for large M.
//
// The products: bf16 x on the tensor cores (mma.sync m16n8k16, fp32
// accumulate), 64 x 128 output tiles, four warps of 32 x 64; fp32 x as true
// fp32 FMA on the CUDA cores (no TF32: the reference holds fp32 to 1e-5),
// 64 x 64 tiles, 4 x 4 outputs a thread. Tiles go through shared memory
// without cp.async or TMA, and neither uses wgmma; those are later steps
// behind the same interface.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// TW, leading dimension ldw. Both tiles sit in shared memory k-contiguous
// (As[m][k], Bs[n][k]), the layout the row.col mma reads as aligned pairs.
template <typename TW>
__global__ void __launch_bounds__(TT)
stream_mm_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const TW* __restrict__ w, long long ldw, int w_nk,
                     float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                     int M, int N, int K, int accumulate, int finish,
                     int vec_x, int vec_w) {
  __shared__ __align__(16) __nv_bfloat16 As[TBM * TP];
  __shared__ __align__(16) __nv_bfloat16 Bs[TBN * TP];

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
template <typename TW>
__global__ void __launch_bounds__(FT)
stream_mm_fma_kernel(const float* __restrict__ x, long long ldx,
                     const TW* __restrict__ w, long long ldw, int w_nk,
                     float* __restrict__ acc, float* __restrict__ out, int M,
                     int N, int K, int accumulate, int finish, int vec_x,
                     int vec_w) {
  __shared__ __align__(16) float As[FBK * (FBM + 4)];
  __shared__ __align__(16) float Bs[FBK * (FBN + 4)];
  constexpr int AP = FBM + 4;
  constexpr int BP = FBN + 4;

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
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * AP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * BP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
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
// launch of one product (the whole K, or one panel of it)
// ---------------------------------------------------------------------------
struct Problem {
  const void* x;
  long long ldx;
  int x_dtype;        // 0 = float32, 1 = bfloat16
  int w_dtype;
  int w_nk;
  float* acc;
  void* out;
  int M, N;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TW>
cudaError_t launch_typed(const Problem& p, const void* x, const void* w,
                         long long ldw, int K, int accumulate, int finish,
                         cudaStream_t stream) {
  const int vw = 16 / static_cast<int>(sizeof(TW));
  const int vec_w = aligned16(w) && ldw % vw == 0;
  if (p.x_dtype == 1) {
    const int vec_x = aligned16(x) && p.ldx % 8 == 0;
    dim3 grid((p.N + TBN - 1) / TBN, (p.M + TBM - 1) / TBM);
    stream_mm_mma_kernel<TW><<<grid, TT, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), p.ldx,
        static_cast<const TW*>(w), ldw, p.w_nk, p.acc,
        static_cast<__nv_bfloat16*>(p.out), p.M, p.N, K, accumulate, finish,
        vec_x, vec_w);
  } else {
    const int vec_x = aligned16(x) && p.ldx % 4 == 0;
    dim3 grid((p.N + FBN - 1) / FBN, (p.M + FBM - 1) / FBM);
    stream_mm_fma_kernel<TW><<<grid, FT, 0, stream>>>(
        static_cast<const float*>(x), p.ldx, static_cast<const TW*>(w), ldw,
        p.w_nk, p.acc, static_cast<float*>(p.out), p.M, p.N, K, accumulate,
        finish, vec_x, vec_w);
  }
  return cudaGetLastError();
}

// x points at the first column of this product's K range; w at its panel.
cudaError_t launch_product(const Problem& p, const void* x, const void* w,
                           long long ldw, int K, int accumulate, int finish,
                           cudaStream_t stream) {
  if ((p.M + TBM - 1) / TBM > 65535) return cudaErrorInvalidConfiguration;
  if (p.w_dtype == 1)
    return launch_typed<__nv_bfloat16>(p, x, w, ldw, K, accumulate, finish,
                                       stream);
  return launch_typed<float>(p, x, w, ldw, K, accumulate, finish, stream);
}

size_t elem_size(int dtype) { return dtype == 1 ? 2 : 4; }

// ---------------------------------------------------------------------------
// the side stream and events of the host route, one set per device
// ---------------------------------------------------------------------------
constexpr int MAX_DEVICES = 64;

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

// Copy K-rows [k0, k0 + kb) of w into ring slot dst, densely: (kb, N) for
// "kn", (N, kb) for "nk".
cudaError_t copy_panel(void* dst, const void* w, long long ldw, int w_nk,
                       size_t es, int N, int k0, int kb, cudaStream_t s) {
  const char* src = static_cast<const char*>(w);
  if (w_nk) {
    return cudaMemcpy2DAsync(dst, kb * es, src + static_cast<size_t>(k0) * es,
                             static_cast<size_t>(ldw) * es, kb * es, N,
                             cudaMemcpyHostToDevice, s);
  }
  src += static_cast<size_t>(k0) * static_cast<size_t>(ldw) * es;
  if (ldw == N)
    return cudaMemcpyAsync(dst, src, static_cast<size_t>(kb) * N * es,
                           cudaMemcpyHostToDevice, s);
  return cudaMemcpy2DAsync(dst, N * es, src, static_cast<size_t>(ldw) * es,
                           N * es, kb, cudaMemcpyHostToDevice, s);
}

}  // namespace

// out (M, N) = x (M, K) @ w, in x's type. dtypes: 0 = float32, 1 = bfloat16.
// w_nk = 0: w is (K, N) with row stride ldw; 1: w is (N, K) with row stride
// ldw. w_on_host = 0: w is device memory, one launch. w_on_host = 1: w is
// pinned host memory and is streamed through ring (2 * min(block_k, K) * N *
// sizeof(w) bytes of device memory); acc is an (M, N) fp32 scratch buffer,
// needed when K > block_k. Launches on `stream` and does not synchronise.
// Returns the CUDA error code (0 = launched).
extern "C" int stream_matmul(const void* x, long long ldx, int x_dtype,
                             const void* w, long long ldw, int w_dtype,
                             int w_nk, int w_on_host, void* ring, float* acc,
                             void* out, int M, int N, int K, int block_k,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || M <= 0 ||
      N <= 0 || K <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{x, ldx, x_dtype, w_dtype, w_nk, acc, out, M, N};
  const size_t xs = elem_size(x_dtype);
  if (!w_on_host)
    return static_cast<int>(launch_product(p, x, w, ldw, K, 0, 1, s));

  // host route: the pointer must be pinned host memory, so that the copies
  // are asynchronous DMA and not staged through a pageable bounce buffer
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.type != cudaMemoryTypeHost)
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = (K + block_k - 1) / block_k;
  if (panels > 1 && acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);

  Streamer* st = nullptr;
  err = streamer_for(&st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t es = elem_size(w_dtype);
  const size_t slot_bytes = static_cast<size_t>(std::min(block_k, K)) * N * es;
  char* slots[2] = {static_cast<char*>(ring),
                    static_cast<char*>(ring) + slot_bytes};

  // the ring may reuse memory the caller's stream was still working on
  if ((err = cudaEventRecord(st->start, s)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(st->copy, st->start, 0)) != cudaSuccess)
    return err;
  err = copy_panel(slots[0], w, ldw, w_nk, es, N, 0, std::min(block_k, K), st->copy);
  if (err != cudaSuccess) return err;
  if ((err = cudaEventRecord(st->copied[0], st->copy)) != cudaSuccess)
    return err;
  for (int j = 0; j < panels; ++j) {
    const int slot = j & 1;
    if (j + 1 < panels) {
      const int nslot = (j + 1) & 1;
      const int k1 = (j + 1) * block_k;
      if (j + 1 >= 2 &&
          (err = cudaStreamWaitEvent(st->copy, st->used[nslot], 0)) != cudaSuccess)
        return err;
      err = copy_panel(slots[nslot], w, ldw, w_nk, es, N, k1,
                       std::min(block_k, K - k1), st->copy);
      if (err != cudaSuccess) return err;
      if ((err = cudaEventRecord(st->copied[nslot], st->copy)) != cudaSuccess)
        return err;
    }
    if ((err = cudaStreamWaitEvent(s, st->copied[slot], 0)) != cudaSuccess)
      return err;
    const int k0 = j * block_k;
    const int kb = std::min(block_k, K - k0);
    const long long ld_panel = w_nk ? kb : N;
    err = launch_product(p, static_cast<const char*>(x) + k0 * xs, slots[slot],
                         ld_panel, kb, j > 0, j == panels - 1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaEventRecord(st->used[slot], s)) != cudaSuccess) return err;
  }
  return 0;
}

extern "C" const char* stream_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
