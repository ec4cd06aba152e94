// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel, pallas_call at line 81).
//
// Computes, for x (B, S, nh, hp), dt (B, S, nh) fp32, A (nh,) fp32 < 0 and
// B_, C_ (B, S, N) with one state group shared by the heads, chunk by chunk
// of Q = 64 tokens, with cum the within-chunk cumulative sum of dt * A:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) C_i . state                                  (carried)
//   state = state exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// with the (hp, N) state of each head in fp32. Beyond the TPU kernel it takes
// an optional init_state, writes the final state when asked (the SSM cache
// that decode reads), and takes any S: rows past S load as zero with dt = 0,
// which is the reference's padding, and are not stored.
//
// What differs from the TPU kernel. There the chunk axis is the innermost,
// sequential grid axis and the (nh_block, hp, N) state lives in VMEM scratch
// between grid steps; its 128 KiB block does not fit one SM's registers. Here
// one thread block owns (batch, head, 16 columns of hp) and loops over the
// chunks itself, with the (16, N) state slice in shared memory. Rows of the
// state are independent given G = C B^T, so the split over hp is exact; it
// gives B * nh * hp / 16 blocks (96 for mamba2-130m, 256 for zamba2-1.2b at
// batch 1) where one block per head would leave most of the 132 SMs idle.
// The (Q, Q) matrices G and M = tril(G * exp(cum_i - cum_j)) * dt_j live in
// shared memory only.
//
// What bounds it. The function moves x, y, B_, C_ and dt once (about 7 MB at
// mamba2's (1, 1024, 24, 64), N 128, in bf16) and does about 0.9 GFLOP of
// the chunked algorithm (G per chunk; the intra, carried and state products
// per head), so operations bound it: ~14 us on fp32 FMA against ~2 us of
// bytes. What the design does about it:
//  * bf16 inputs: G = C B^T runs on the tensor cores (mma.sync m16n8k16, fp32
//    accumulate, tiles wholly above the diagonal skipped): its products of
//    bf16 values are exact, and it is the one product every block repeats
//    for its head. The decay-weighted products stay fp32 FMA.
//  * fp32 inputs: every product is fp32 FMA on the CUDA cores (no TF32), so
//    fp32 stays within the reference's 1e-4.
// Each block recomputes G for its chunk (4 to 16 times the minimal work for
// that term), reads B_ and C_ once per block from L2, and does not overlap
// its loads with its products (no cp.async / TMA ring, no wgmma yet).
#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_bf16_m16n8k16;

constexpr int Q = 64;       // tokens per chunk
constexpr int TP = 16;      // hp columns (state rows) per block
constexpr int NT = 256;     // threads per block
constexpr int GP = Q + 1;   // pitch of the (Q, Q) tile
constexpr int PG = 4;       // state rows per thread in the state update

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Byte offsets of the shared-memory tiles for state size N. B_ and C_ tiles
// keep the input type: fp32 with an odd pitch (conflict-free column reads),
// bf16 with pitch N + 8 (aligned 32-bit pairs for mma.sync).
struct Layout {
  int pb;
  unsigned b, c, g, x, xw, s, cum, dt, dec, bytes;
};

__host__ __device__ inline unsigned align16(unsigned v) { return (v + 15u) & ~15u; }

template <typename T>
__host__ __device__ inline Layout layout(int N) {
  Layout L;
  L.pb = sizeof(T) == 4 ? N + 1 : N + 8;
  unsigned o = 0;
  L.b = o;   o += align16(Q * L.pb * sizeof(T));
  L.c = o;   o += align16(Q * L.pb * sizeof(T));
  L.g = o;   o += align16(Q * GP * 4);
  L.x = o;   o += align16(Q * TP * 4);
  L.xw = o;  o += align16(Q * TP * 4);
  L.s = o;   o += align16(TP * (N + 1) * 4);
  L.cum = o; o += align16(Q * 4);
  L.dt = o;  o += align16(Q * 4);
  L.dec = o; o += align16(Q * 4);
  L.bytes = o;
  return L;
}

// G = C B^T of one chunk into Gs (pitch GP), fp32 FMA: each thread a 4 x 4
// tile, rows ty + 16 a and columns tx + 16 b.
__device__ __forceinline__ void scores(float* Gs, const float* Cs,
                                       const float* Bs, int pb, int N) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * pb + n];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bs[(tx + 16 * b) * pb + n];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) Gs[(ty + 16 * a) * GP + tx + 16 * b] = acc[a][b];
}

// The same on the tensor cores for bf16: warp w takes the 16 rows 16 (w / 2)
// and four 8-column tiles; a tile wholly above the diagonal is skipped (the
// mask below never reads it).
__device__ __forceinline__ void scores(float* Gs, const __nv_bfloat16* Cs,
                                       const __nv_bfloat16* Bs, int pb, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp / 2);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c0 = 8 * ((warp % 2) * 4 + q);
    if (c0 > r0 + 15) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < N; k0 += 16) {
      const __nv_bfloat16* ca = Cs + (r0 + g) * pb + k0 + 2 * t;
      const uint32_t af[4] = {ld32(ca), ld32(ca + 8 * pb), ld32(ca + 8),
                              ld32(ca + 8 * pb + 8)};
      const __nv_bfloat16* bb = Bs + (c0 + g) * pb + k0 + 2 * t;
      mma_bf16_m16n8k16(acc, af, ld32(bb), ld32(bb + 8));
    }
    float* dst = Gs + (r0 + g) * GP + c0 + 2 * t;
    dst[0] = acc[0];
    dst[1] = acc[1];
    dst[8 * GP] = acc[2];
    dst[8 * GP + 1] = acc[3];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init_state,
                T* __restrict__ y, float* __restrict__ final_state, int S,
                int nh, int hp, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(N);
  T* Bs = reinterpret_cast<T*>(smem + L.b);
  T* Cs = reinterpret_cast<T*>(smem + L.c);
  float* Gs = reinterpret_cast<float*>(smem + L.g);
  float* Xs = reinterpret_cast<float*>(smem + L.x);
  float* XWs = reinterpret_cast<float*>(smem + L.xw);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  float* dec = reinterpret_cast<float*>(smem + L.dec);
  const int pb = L.pb, sp = N + 1;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  // [b][h][p0][0] of a (B, nh, hp, N) state: the block's rows are contiguous
  const size_t state0 = ((static_cast<size_t>(b) * nh + h) * hp + p0) * N;

  for (int i = tid; i < TP * N; i += NT) {
    const int p = i / N, n = i - p * N;
    Ss[p * sp + n] = init_state != nullptr ? init_state[state0 + i] : 0.f;
  }

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int valid = min(Q, S - c * Q);
    const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

    __syncthreads();  // the previous chunk is done with every tile
    if (tid < Q) {
      const float d = tid < valid ? dt[(row0 + tid) * nh + h] : 0.f;
      dts[tid] = d;
      cum[tid] = d * a;
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int r = i / N, n = i - r * N;
      T bv = from_f<T>(0.f), cv = from_f<T>(0.f);
      if (r < valid) {
        bv = Bm[(row0 + r) * N + n];
        cv = Cm[(row0 + r) * N + n];
      }
      Bs[r * pb + n] = bv;
      Cs[r * pb + n] = cv;
    }
    for (int i = tid; i < Q * TP; i += NT) {
      const int r = i / TP, p = i - r * TP;
      Xs[i] = r < valid ? to_f(x[((row0 + r) * nh + h) * hp + p0 + p]) : 0.f;
    }
    __syncthreads();

    // cum: inclusive prefix sum of dt * A over the chunk, one warp, two rows
    // a lane; padded rows add 0
    if (tid < 32) {
      const float v0 = cum[2 * tid];
      const float v1 = v0 + cum[2 * tid + 1];
      float s = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += u;
      }
      cum[2 * tid] = s - v1 + v0;
      cum[2 * tid + 1] = s;
    }
    scores(Gs, Cs, Bs, pb, N);
    __syncthreads();

    // M = tril(G * exp(cum_i - cum_j)) * dt_j in place; the weight of row j
    // in the state update, exp(cum_last - cum_j) * dt_j
    for (int i = tid; i < Q * Q; i += NT) {
      const int r = i / Q, j = i - r * Q;
      Gs[r * GP + j] = j <= r ? Gs[r * GP + j] * expf(cum[r] - cum[j]) * dts[j] : 0.f;
    }
    if (tid < Q) dec[tid] = expf(cum[Q - 1] - cum[tid]) * dts[tid];
    __syncthreads();

    // y = M x + exp(cum_i) * C state^T, with the state entering the chunk:
    // each thread one column p and the rows r0 + 16 k
    {
      const int p = tid % TP, r0 = tid / TP;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, carried[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Q; ++j) {
        const float xv = Xs[j * TP + p];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(Gs[(r0 + 16 * k) * GP + j], xv, acc[k]);
      }
      for (int n = 0; n < N; ++n) {
        const float sv = Ss[p * sp + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          carried[k] = fmaf(to_f(Cs[(r0 + 16 * k) * pb + n]), sv, carried[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + 16 * k;
        if (r < valid)
          y[((row0 + r) * nh + h) * hp + p0 + p] =
              from_f<T>(acc[k] + expf(cum[r]) * carried[k]);
      }
    }
    for (int i = tid; i < Q * TP; i += NT) XWs[i] = Xs[i] * dec[i / TP];
    __syncthreads();

    // state = state * exp(cum_last) + sum_j B_j^T (dec_j x_j): each thread
    // one column n of PG consecutive state rows
    const float total = expf(cum[Q - 1]);
    for (int i = tid; i < (TP / PG) * N; i += NT) {
      const int pg = i / N, n = i - pg * N;
      float acc[PG] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Q; ++j) {
        const float bv = to_f(Bs[j * pb + n]);
        const float4 w = *reinterpret_cast<const float4*>(XWs + j * TP + pg * PG);
        acc[0] = fmaf(bv, w.x, acc[0]);
        acc[1] = fmaf(bv, w.y, acc[1]);
        acc[2] = fmaf(bv, w.z, acc[2]);
        acc[3] = fmaf(bv, w.w, acc[3]);
      }
#pragma unroll
      for (int k = 0; k < PG; ++k) {
        float* sv = Ss + (pg * PG + k) * sp + n;
        *sv = *sv * total + acc[k];
      }
    }
  }

  if (final_state != nullptr) {
    __syncthreads();
    for (int i = tid; i < TP * N; i += NT) {
      const int p = i / N, n = i - p * N;
      final_state[state0 + i] = Ss[p * sp + n];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init_state,
                   void* y, float* final_state, int Bb, int S, int nh, int hp,
                   int N, cudaStream_t stream) {
  const Layout L = layout<T>(N);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(hp / TP, nh, Bb);
  kern<<<grid, dim3(NT), L.bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init_state, static_cast<T*>(y), final_state,
      S, nh, hp, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_ and y); dt, A, init_state and
// final_state are fp32. Every tensor is contiguous: x, y (B, S, nh, hp); dt
// (B, S, nh); A (nh,); B_, C_ (B, S, N); states (B, nh, hp, N). init_state
// and final_state may be nullptr (start from zero; no final state). hp must
// be a multiple of 16, N a multiple of 16 up to 256. Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init_state,
                        void* y, void* final_state, int Bb, int S, int nh,
                        int hp, int N, int dtype, void* stream) {
  if (hp % TP != 0 || N % 16 != 0 || N < 16 || N > 256 || Bb < 1 || S < 1 ||
      nh < 1 || nh > 65535 || Bb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* init = static_cast<const float*>(init_state);
  float* fin = static_cast<float*>(final_state);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, dtf, Af, Bm, Cm, init, y, fin, Bb, S, nh, hp, N, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, init, y, fin, Bb, S, nh, hp,
                                N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
