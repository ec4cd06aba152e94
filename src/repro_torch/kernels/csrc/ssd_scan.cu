// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel, pallas_call at line 81).
//
// Computes, for x (B, S, nh, hp), dt (B, S, nh) fp32, A (nh,) fp32 < 0 and
// B_, C_ (B, S, N) with one state group shared by the heads, chunk by chunk
// of Q = 64 tokens, with cum the within-chunk cumulative sum of dt * A:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) C_i . h_c                                    (carried)
//   h_{c+1} = h_c exp(cum_last) + S_c,
//   S_c   = sum_j B_j exp(cum_last - cum_j) dt_j x_j                (chunk state)
// with the (hp, N) state h of each head in fp32, h_0 = init_state (or zero).
// Beyond the TPU kernel it takes an optional init_state, writes the final
// state when asked (the SSM cache that decode reads), and takes any S: rows
// past S load as zero with dt = 0, which is the reference's padding, and are
// not stored.
//
// What differs from the TPU kernel. There the chunk axis is the innermost,
// sequential grid axis and the state lives in VMEM scratch between grid
// steps. Here the sequence dependence, which runs only through h, is split
// out, and everything else runs in parallel over chunks, in three launches:
//  1. chunk_state: per (batch, chunk, group of heads), S_c and the chunk's
//     total decay cum_last, into fp32 scratch the wrapper allocates.
//  2. state_pass: per state element, the serial pass h_{c+1} = h_c
//     exp(cum_last_c) + S_c from init_state; it writes the state entering
//     every chunk (in x's type) and the final state (fp32). Only this pass is
//     sequential, and it is elementwise.
//  3. chunk_scan: per (batch, chunk, group of heads), G = C B^T once for the
//     chunk (shared by the block's heads), then per head the mask and decay
//     M = tril(G o exp(cum_i - cum_j)) o dt_j, the intra output M x and the
//     carried output exp(cum_i) C h_c^T, summed and stored once.
// One kernel whose blocks wait on chunk c - 1's flag before passing the state
// on was the other design; it was built and measured, and lost by an order
// of magnitude at 16 chunks (PERF.md): its chain runs through every chunk's
// block in turn, where state_pass runs each element's chain in parallel.
//
// What bounds it. The function moves x, y, B_, C_ and dt once (about 7 MB at
// mamba2's (1, 1024, 24, 64), N 128, in bf16) and does about 1 GFLOP of
// the chunked algorithm: in bf16 on the tensor cores some 1-2 us against
// ~2 us of bytes; the scratch's state traffic (S_c written and read once,
// h_c written and read once: ~25 MB, mostly in L2) and the three launches
// are what the design pays for the parallelism. What it does:
//  * bf16 inputs: every product on the tensor cores (mma.sync m16n8k16,
//    fp32 accumulate), operands read from shared memory by ldmatrix. G's
//    and C's products with bf16 inputs are exact; M and h_c are rounded to
//    bf16 for theirs (y is held at 2e-2). The chunk state is held at 1e-4,
//    which one bf16 rounding of dec o x would miss, so its operand is split
//    in two bf16 halves, hi = bf16(v) and lo = bf16(v - hi), and both are
//    multiplied: the sum carries ~16 bits of v.
//  * fp32 inputs: every product in fp32 FMA on the CUDA cores (no TF32), so
//    fp32 stays within the reference's 1e-4.
//  * loads: every tile (x, B_, C_, h_c) by 16-byte cp.async into padded
//    shared memory (rows past S zero-filled), the next head's tiles in
//    flight while the block multiplies the current one; dt (a row stride of
//    nh * 4 bytes) by plain loads.
//  * deterministic: every sum in one fixed order, no atomics.
#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::mma_bf16_m16n8k16;
using flash::pack_bf16;

constexpr int Q = 64;        // tokens per chunk
constexpr int NT = 128;      // threads per block: four warps
constexpr int PC = 64;       // hp columns of one bf16 unit of work
constexpr int PCF = 32;      // hp columns of one fp32 unit of work
constexpr int PASS_U = 4;    // chunks whose states state_pass loads at once

__host__ __device__ inline unsigned align16(unsigned v) { return (v + 15u) & ~15u; }

// ---------------------------------------------------------------------------
// element helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes global -> shared, zero-filled when !valid
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols elements of T (cols a multiple of 16 bytes) from a row-major
// source with row stride ld into shared memory with pitch `pitch`; rows at
// or past rows_valid read as zero
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int pitch, const T* src,
                                                long long ld, int rows, int cols,
                                                int rows_valid) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int runs = cols / V;
  for (int i = threadIdx.x; i < rows * runs; i += NT) {
    const int r = i / runs, c = (i - r * runs) * V;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// the chunk's cumulative decay: lane l of a warp holds rows 2l and 2l + 1
// ---------------------------------------------------------------------------
struct Cum {
  float dt0, dt1;    // dt of rows 2l, 2l + 1 (0 past S)
  float c0, c1;      // inclusive cumulative sums of dt * a there
  float last;        // cum of the chunk's last row
};

__device__ __forceinline__ Cum chunk_cum(const float* dt, size_t row0, int nh,
                                         int h, int valid, float a) {
  const int lane = threadIdx.x & 31;
  Cum r;
  r.dt0 = 2 * lane < valid ? dt[(row0 + 2 * lane) * nh + h] : 0.f;
  r.dt1 = 2 * lane + 1 < valid ? dt[(row0 + 2 * lane + 1) * nh + h] : 0.f;
  const float v0 = r.dt0 * a, v1 = v0 + r.dt1 * a;
  float s = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += u;
  }
  r.c0 = s - v1 + v0;
  r.c1 = s;
  r.last = __shfl_sync(0xffffffffu, s, 31);
  return r;
}

// ---------------------------------------------------------------------------
// tensor cores: ldmatrix fragments for mma.sync m16n8k16 (flash_common.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment (rows m0.., k k0.., 16 x 16) of a tile stored [m][k]
// (k contiguous, pitch P).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int P,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  ldsm4(a, t + (m0 + r + 8 * (q & 1)) * P + k0 + 8 * (q >> 1));
}
// The A fragment of a tile stored [k][m] (m contiguous).
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* t, int P,
                                         int m0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  ldsm4t(a, t + (k0 + r + 8 * (q >> 1)) * P + m0 + 8 * (q & 1));
}
// B fragments of two neighbouring n tiles (n0.., n0 + 8..; k k0.., 16 deep)
// of a tile stored [n][k] (k contiguous): b[0], b[1] for the first, b[2],
// b[3] for the second.
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* t, int P,
                                        int n0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  ldsm4(b, t + (n0 + r + 8 * (q >> 1)) * P + k0 + 8 * (q & 1));
}
// The same of a tile stored [k][n] (n contiguous).
__device__ __forceinline__ void frag_b2_t(uint32_t (&b)[4], const bf16* t, int P,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  ldsm4t(b, t + (k0 + r + 8 * (q & 1)) * P + n0 + 8 * (q >> 1));
}

// ---------------------------------------------------------------------------
// shared-memory layouts (byte offsets), for state size N
// ---------------------------------------------------------------------------
// bf16 tiles: pitch = columns + 8 elements (rows 16 bytes apart modulo 128:
// ldmatrix reads eight rows without bank conflicts). fp32: columns + 4.
__host__ __device__ inline int pitch_of(int cols, int elem) {
  return cols + (elem == 2 ? 8 : 4);
}

struct StateLayout {        // chunk_state
  unsigned b, x, whi, wlo, w, bytes;
};
template <typename T>
__host__ __device__ inline StateLayout state_layout(int N, int hg) {
  constexpr int E = sizeof(T);
  const int pc = E == 2 ? PC : PCF;
  StateLayout L;
  unsigned o = 0;
  L.b = o;   o += align16(Q * pitch_of(N, E) * E);
  L.x = o;   o += align16(2 * Q * pitch_of(pc, E) * E);      // two buffers
  L.whi = o; o += E == 2 ? align16(Q * pitch_of(pc, E) * E) : 0;
  L.wlo = o; o += E == 2 ? align16(Q * pitch_of(pc, E) * E) : 0;
  L.w = o;   o += align16(hg * Q * 4);
  L.bytes = o;
  return L;
}

struct ScanLayout {         // chunk_scan
  unsigned c, b, x, h, g, m, cum, dt, bytes;
};
template <typename T>
__host__ __device__ inline ScanLayout scan_layout(int N) {
  constexpr int E = sizeof(T);
  ScanLayout L;
  unsigned o = 0;
  L.c = o; o += align16(Q * pitch_of(N, E) * E);
  L.b = o; o += align16(Q * pitch_of(N, E) * E);
  if (E == 2) {   // two buffers of x and h: the next unit's load in flight
    L.x = o; o += align16(2 * Q * pitch_of(PC, 2) * 2);
    L.h = o; o += align16(2 * PC * pitch_of(N, 2) * 2);
    L.g = L.m = L.cum = L.dt = o;
  } else {        // one of each; G and M in shared memory
    L.x = o;   o += align16(Q * pitch_of(PCF, 4) * 4);
    L.h = o;   o += align16(PCF * pitch_of(N, 4) * 4);
    L.g = o;   o += align16(Q * (Q + 1) * 4);
    L.m = o;   o += align16(Q * (Q + 1) * 4);
    L.cum = o; o += align16(Q * 4);
    L.dt = o;  o += align16(Q * 4);
  }
  L.bytes = o;
  return L;
}

// The block's units of work: (head hh of the block's hg, hp columns p0 ..
// p0 + pc) for pc-column slices of hp.
struct Unit {
  int hh, p0, pw;
};
__device__ __forceinline__ Unit unit_of(int u, int hp, int pc) {
  const int per = (hp + pc - 1) / pc;
  Unit r;
  r.hh = u / per;
  r.p0 = (u - r.hh * per) * pc;
  r.pw = min(pc, hp - r.p0);
  return r;
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------
// Block (head group, chunk c, batch b) over heads h0 .. h0 + hg - 1: the
// weights w_j = exp(cum_last - cum_j) dt_j of each head (warp w takes heads
// w, w + 4, ...), seg = cum_last, and S_c[h] (hp, N) = sum_j (w_j x_j)^T B_j
// into chunk_state[b][c][h].
template <typename T>
__global__ void __launch_bounds__(NT)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ chunk_state, float* __restrict__ seg,
                   int S, int nh, int hp, int N, int hg) {
  constexpr int E = sizeof(T);
  constexpr int pc = E == 2 ? PC : PCF;
  extern __shared__ __align__(16) unsigned char smem[];
  const StateLayout L = state_layout<T>(N, hg);
  T* Bs = reinterpret_cast<T*>(smem + L.b);
  T* Xs = reinterpret_cast<T*>(smem + L.x);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  const int PB = pitch_of(N, E), PX = pitch_of(pc, E);

  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int valid = min(Q, S - c * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = hg * ((hp + pc - 1) / pc);

  auto load_x = [&](int u) {
    const Unit un = unit_of(u, hp, pc);
    load_tile_async(Xs + (u & 1) * Q * PX, PX,
                    x + (row0 * nh + h0 + un.hh) * hp + un.p0,
                    static_cast<long long>(nh) * hp, Q, un.pw, valid);
  };
  load_tile_async(Bs, PB, Bm + row0 * N, N, Q, N, valid);
  load_x(0);
  cp_async_commit();

  for (int hh = warp; hh < hg; hh += NT / 32) {
    const Cum cm = chunk_cum(dt, row0, nh, h0 + hh, valid, A[h0 + hh]);
    ws[hh * Q + 2 * lane] = expf(cm.last - cm.c0) * cm.dt0;
    ws[hh * Q + 2 * lane + 1] = expf(cm.last - cm.c1) * cm.dt1;
    if (lane == 0) seg[(static_cast<size_t>(b) * nc + c) * nh + h0 + hh] = cm.last;
  }

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) load_x(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // unit u's x (and B_) landed, the weights are written
    const Unit un = unit_of(u, hp, pc);
    const float* w = ws + un.hh * Q;
    const T* X = Xs + (u & 1) * Q * PX;
    float* out = chunk_state +
                 ((static_cast<size_t>(b) * nc + c) * nh + h0 + un.hh) * hp * N;
    if constexpr (E == 2) {
      // the operand (w_j x_j) as two bf16 halves, stored [j][p] like x
      bf16* Whi = reinterpret_cast<bf16*>(smem + L.whi);
      bf16* Wlo = reinterpret_cast<bf16*>(smem + L.wlo);
      for (int i = threadIdx.x; i < Q * un.pw / 2; i += NT) {
        const int j = i / (un.pw / 2), p = 2 * (i - j * (un.pw / 2));
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(X + j * PX + p);
        const float v0 = __low2float(xv) * w[j], v1 = __high2float(xv) * w[j];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(Whi + j * PX + p) = hi;
        *reinterpret_cast<__nv_bfloat162*>(Wlo + j * PX + p) =
            __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
      }
      __syncthreads();
      // items: 16 rows of p x 64 columns of n, shared out over the warps
      const int n_chunks = (N + 63) / 64;
      const int g = lane >> 2, t4 = lane & 3;
      for (int it = warp; it < (un.pw / 16) * n_chunks; it += NT / 32) {
        const int m0 = 16 * (it / n_chunks), n0 = 64 * (it % n_chunks);
        const int ntiles = min(8, (N - n0) / 8);
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < Q / 16; ++ks) {
          uint32_t ahi[4], alo[4];
          frag_a_t(ahi, Whi, PX, m0, 16 * ks);
          frag_a_t(alo, Wlo, PX, m0, 16 * ks);
#pragma unroll
          for (int t = 0; t < 8; t += 2) {
            if (t < ntiles) {
              uint32_t bb[4];
              frag_b2_t(bb, reinterpret_cast<const bf16*>(Bs), PB, n0 + 8 * t, 16 * ks);
              mma_bf16_m16n8k16(acc[t], ahi, bb[0], bb[1]);
              mma_bf16_m16n8k16(acc[t], alo, bb[0], bb[1]);
              mma_bf16_m16n8k16(acc[t + 1], ahi, bb[2], bb[3]);
              mma_bf16_m16n8k16(acc[t + 1], alo, bb[2], bb[3]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t < ntiles) {
            const int p = un.p0 + m0 + g, n = n0 + 8 * t + 2 * t4;
            *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * N + n) =
                make_float2(acc[t][0], acc[t][1]);
            *reinterpret_cast<float2*>(out + static_cast<size_t>(p + 8) * N + n) =
                make_float2(acc[t][2], acc[t][3]);
          }
        }
      }
    } else {
      // fp32: each thread four neighbouring n of one p, summed over j
      const int n4 = N / 4;
      for (int o = threadIdx.x; o < un.pw * n4; o += NT) {
        const int p = o / n4, n = 4 * (o - p * n4);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < Q; ++j) {
          const float xw = to_f(X[j * PX + p]) * w[j];
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * PB + n);
          acc.x = fmaf(xw, bv.x, acc.x);
          acc.y = fmaf(xw, bv.y, acc.y);
          acc.z = fmaf(xw, bv.z, acc.z);
          acc.w = fmaf(xw, bv.w, acc.w);
        }
        *reinterpret_cast<float4*>(out + static_cast<size_t>(un.p0 + p) * N + n) = acc;
      }
    }
    __syncthreads();   // unit u's tiles are no longer read
  }
}

// ---------------------------------------------------------------------------
// 2. the serial pass over chunks, elementwise
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Thread: four neighbouring elements e of the (hp, N) state of head h,
// batch b (E = hp * N elements). h_in[b][c][h] gets the state entering
// chunk c, in T; final_state the state after the last chunk.
template <typename T>
__global__ void __launch_bounds__(NT)
state_pass_kernel(const float* __restrict__ chunk_state,
                  const float* __restrict__ seg,
                  const float* __restrict__ init_state, T* __restrict__ h_in,
                  float* __restrict__ final_state, int nc, int nh, int E) {
  const int e = 4 * (blockIdx.x * NT + threadIdx.x);
  if (e >= E) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * nh + h;
  float4 s = init_state != nullptr
                 ? *reinterpret_cast<const float4*>(init_state + bh * E + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_U) {
    float4 inc[PASS_U];
    float dec[PASS_U];
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c) * nh + h;
        inc[u] = *reinterpret_cast<const float4*>(chunk_state + slot * E + e);
        dec[u] = expf(seg[slot]);
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c) * nh + h;
        store4(h_in + slot * E + e, s);
        s.x = fmaf(s.x, dec[u], inc[u].x);
        s.y = fmaf(s.y, dec[u], inc[u].y);
        s.z = fmaf(s.z, dec[u], inc[u].z);
        s.w = fmaf(s.w, dec[u], inc[u].w);
      }
    }
  }
  if (final_state != nullptr) store4(final_state + bh * E + e, s);
}

// ---------------------------------------------------------------------------
// 3. chunk outputs: intra-chunk and carried
// ---------------------------------------------------------------------------
// bf16: warp w owns rows 16 w .. 16 w + 15 of the chunk. G = C B^T stays in
// its registers for the block's heads; per unit (head, 64 columns of hp) the
// warp forms M from G in registers as the A operand of M x, and multiplies
// C (from shared memory) by h^T for the carried part.
__global__ void __launch_bounds__(NT)
chunk_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const bf16* __restrict__ h_in,
                      bf16* __restrict__ y, int S, int nh, int hp, int N, int hg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout L = scan_layout<bf16>(N);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  const int PN = pitch_of(N, 2), PX = pitch_of(PC, 2);

  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int valid = min(Q, S - c * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int units = hg * ((hp + PC - 1) / PC);

  auto load_unit = [&](int u) {
    const Unit un = unit_of(u, hp, PC);
    const int h = h0 + un.hh;
    load_tile_async(Xs + (u & 1) * Q * PX, PX, x + (row0 * nh + h) * hp + un.p0,
                    static_cast<long long>(nh) * hp, Q, un.pw, valid);
    load_tile_async(Hs + (u & 1) * PC * PN, PN,
                    h_in + (((static_cast<size_t>(b) * nc + c) * nh + h) * hp + un.p0) * N,
                    N, PC, N, un.pw);
  };
  load_tile_async(Cs, PN, Cm + row0 * N, N, Q, N, valid);
  load_tile_async(Bs, PN, Bm + row0 * N, N, Q, N, valid);
  load_unit(0);
  cp_async_commit();

  const int r0 = 16 * warp;
  float G[8][4];
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) load_unit(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // unit u's tiles (and C_, B_) landed
    if (u == 0) {
      // G rows r0 .. r0 + 15, all 64 columns; tiles wholly above the
      // diagonal are never read
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[t][e] = 0.f;
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[4];
        frag_a(a, Cs, PN, r0, k0);
#pragma unroll
        for (int t = 0; t < 8; t += 2) {
          if (8 * t <= r0 + 15) {
            uint32_t bb[4];
            frag_b2(bb, Bs, PN, 8 * t, k0);
            mma_bf16_m16n8k16(G[t], a, bb[0], bb[1]);
            mma_bf16_m16n8k16(G[t + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    const Unit un = unit_of(u, hp, PC);
    const int h = h0 + un.hh;
    const Cum cm = chunk_cum(dt, row0, nh, h, valid, A[h]);
    // cum and dt of any row j from the lane that holds it
    auto cum_at = [&](int j) {
      const float v0 = __shfl_sync(0xffffffffu, cm.c0, j >> 1);
      const float v1 = __shfl_sync(0xffffffffu, cm.c1, j >> 1);
      return (j & 1) ? v1 : v0;
    };
    const float ci0 = cum_at(r0 + g), ci1 = cum_at(r0 + g + 8);
    // M = tril(G o exp(cum_i - cum_j)) o dt_j as bf16 A fragments, k = j
    uint32_t mf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float m[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * t + 2 * t4 + e;
        const float cj0 = __shfl_sync(0xffffffffu, cm.c0, 4 * t + t4);
        const float cj1 = __shfl_sync(0xffffffffu, cm.c1, 4 * t + t4);
        const float dj0 = __shfl_sync(0xffffffffu, cm.dt0, 4 * t + t4);
        const float dj1 = __shfl_sync(0xffffffffu, cm.dt1, 4 * t + t4);
        const float cj = e ? cj1 : cj0, dj = e ? dj1 : dj0;
        m[e] = j <= r0 + g ? G[t][e] * expf(ci0 - cj) * dj : 0.f;
        m[2 + e] = j <= r0 + g + 8 ? G[t][2 + e] * expf(ci1 - cj) * dj : 0.f;
      }
      // n tile t is half of k step t / 2: a0 / a1 (t even) or a2 / a3 (odd)
      mf[t >> 1][(t & 1) * 2] = pack_bf16(m[0], m[1]);
      mf[t >> 1][(t & 1) * 2 + 1] = pack_bf16(m[2], m[3]);
    }
    const float ei0 = expf(ci0), ei1 = expf(ci1);
    const bf16* X = Xs + (u & 1) * Q * PX;
    const bf16* H = Hs + (u & 1) * PC * PN;
    const int ntiles = un.pw / 8;
    float yi[8][4], yc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[t][e] = yc[t][e] = 0.f;
    // intra: M x over k steps at or below the diagonal
#pragma unroll
    for (int ks = 0; ks < Q / 16; ++ks) {
      if (ks <= warp) {
#pragma unroll
        for (int t = 0; t < 8; t += 2) {
          if (t < ntiles) {
            uint32_t bb[4];
            frag_b2_t(bb, X, PX, 8 * t, 16 * ks);
            mma_bf16_m16n8k16(yi[t], mf[ks], bb[0], bb[1]);
            mma_bf16_m16n8k16(yi[t + 1], mf[ks], bb[2], bb[3]);
          }
        }
      }
    }
    // carried: C h^T
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      frag_a(a, Cs, PN, r0, k0);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        if (t < ntiles) {
          uint32_t bb[4];
          frag_b2(bb, H, PN, 8 * t, k0);
          mma_bf16_m16n8k16(yc[t], a, bb[0], bb[1]);
          mma_bf16_m16n8k16(yc[t + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < ntiles) {
        const int p = un.p0 + 8 * t + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + g + 8 * half;
          if (i < valid) {
            const float ei = half ? ei1 : ei0;
            const float v0 = yi[t][2 * half] + ei * yc[t][2 * half];
            const float v1 = yi[t][2 * half + 1] + ei * yc[t][2 * half + 1];
            *reinterpret_cast<uint32_t*>(y + ((row0 + i) * nh + h) * hp + p) =
                pack_bf16(v0, v1);
          }
        }
      }
    }
    __syncthreads();   // unit u's buffers are no longer read
  }
}

// fp32: G, then per unit M, in shared memory; each thread a set of (i, p)
// outputs, fp32 FMA throughout.
__global__ void __launch_bounds__(NT)
chunk_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const float* __restrict__ h_in,
                      float* __restrict__ y, int S, int nh, int hp, int N, int hg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout L = scan_layout<float>(N);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  float* Bs = reinterpret_cast<float*>(smem + L.b);
  float* Xs = reinterpret_cast<float*>(smem + L.x);
  float* Hs = reinterpret_cast<float*>(smem + L.h);
  float* Gs = reinterpret_cast<float*>(smem + L.g);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  const int PN = pitch_of(N, 4), PX = pitch_of(PCF, 4), GP = Q + 1;

  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int valid = min(Q, S - c * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int lane = threadIdx.x & 31;
  const int units = hg * ((hp + PCF - 1) / PCF);

  load_tile_async(Cs, PN, Cm + row0 * N, N, Q, N, valid);
  load_tile_async(Bs, PN, Bm + row0 * N, N, Q, N, valid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int o = threadIdx.x; o < Q * Q; o += NT) {
    const int i = o / Q, j = o - i * Q;
    float s = 0.f;
    if (j <= i)
      for (int n = 0; n < N; ++n) s = fmaf(Cs[i * PN + n], Bs[j * PN + n], s);
    Gs[i * GP + j] = s;
  }

  for (int u = 0; u < units; ++u) {
    const Unit un = unit_of(u, hp, PCF);
    const int h = h0 + un.hh;
    __syncthreads();   // the previous unit's tiles are no longer read
    load_tile_async(Xs, PX, x + (row0 * nh + h) * hp + un.p0,
                    static_cast<long long>(nh) * hp, Q, un.pw, valid);
    load_tile_async(Hs, PN,
                    h_in + (((static_cast<size_t>(b) * nc + c) * nh + h) * hp + un.p0) * N,
                    N, PCF, N, un.pw);
    cp_async_commit();
    if (threadIdx.x < 32) {
      const Cum cm = chunk_cum(dt, row0, nh, h, valid, A[h]);
      cum[2 * lane] = cm.c0;
      cum[2 * lane + 1] = cm.c1;
      dts[2 * lane] = cm.dt0;
      dts[2 * lane + 1] = cm.dt1;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < Q * Q; o += NT) {
      const int i = o / Q, j = o - i * Q;
      Ms[i * GP + j] = j <= i ? Gs[i * GP + j] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int o = threadIdx.x; o < Q * un.pw; o += NT) {
      const int i = o / un.pw, p = o - i * un.pw;
      float yi = 0.f, yc = 0.f;
      for (int j = 0; j <= i; ++j) yi = fmaf(Ms[i * GP + j], Xs[j * PX + p], yi);
      for (int n = 0; n < N; ++n) yc = fmaf(Cs[i * PN + n], Hs[p * PN + n], yc);
      if (i < valid)
        y[((row0 + i) * nh + h) * hp + un.p0 + p] = yi + expf(cum[i]) * yc;
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Lets kern use `bytes` of dynamic shared memory on the current device;
// allowed[device] remembers the largest amount set, so the call (host time
// a prefill-sized scan does not have to spare) is made once per size.
template <typename Kernel>
cudaError_t set_smem(Kernel kern, unsigned bytes, unsigned* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < MAX_DEVICES && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init_state,
                   void* y, float* final_state, float* chunk_state,
                   float* seg, void* h_in, int Bb, int S, int nh, int hp,
                   int N, int hg, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const dim3 grid(nh / hg, nc, Bb);
  const StateLayout SL = state_layout<T>(N, hg);
  const ScanLayout CL = scan_layout<T>(N);
  static unsigned state_allowed[MAX_DEVICES] = {};
  static unsigned scan_allowed[MAX_DEVICES] = {};
  cudaError_t err = set_smem(chunk_state_kernel<T>, SL.bytes, state_allowed);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T><<<grid, NT, SL.bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), chunk_state,
      seg, S, nh, hp, N, hg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int E = hp * N;
  state_pass_kernel<T><<<dim3((E / 4 + NT - 1) / NT, nh, Bb), NT, 0, stream>>>(
      chunk_state, seg, init_state, static_cast<T*>(h_in), final_state, nc, nh, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if constexpr (sizeof(T) == 2) {
    err = set_smem(chunk_scan_mma_kernel, CL.bytes, scan_allowed);
    if (err != cudaSuccess) return err;
    chunk_scan_mma_kernel<<<grid, NT, CL.bytes, stream>>>(
        static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), static_cast<const bf16*>(h_in),
        static_cast<bf16*>(y), S, nh, hp, N, hg);
  } else {
    err = set_smem(chunk_scan_fma_kernel, CL.bytes, scan_allowed);
    if (err != cudaSuccess) return err;
    chunk_scan_fma_kernel<<<grid, NT, CL.bytes, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(h_in),
        static_cast<float*>(y), S, nh, hp, N, hg);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_, y and h_in); dt, A,
// init_state, final_state, chunk_state and seg are fp32. Every tensor is
// contiguous, x, B_, C_ and the states 16-byte aligned: x, y (B, S, nh, hp); dt (B, S, nh); A
// (nh,); B_, C_ (B, S, N); states (B, nh, hp, N). Scratch the caller
// allocates, nc = ceil(S / 64): chunk_state and h_in (B, nc, nh, hp, N), seg
// (B, nc, nh). init_state and final_state may be nullptr (start from zero;
// no final state). hp must be a multiple of 16, N a multiple of 16 up to
// 256, and hg (heads a block takes) must divide nh. Launches the three
// kernels on `stream`; returns the CUDA error code (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init_state,
                        void* y, void* final_state, void* chunk_state,
                        void* seg, void* h_in, int Bb, int S, int nh, int hp,
                        int N, int hg, int dtype, void* stream) {
  if (hp % 16 != 0 || N % 16 != 0 || N < 16 || N > 256 || Bb < 1 || S < 1 ||
      nh < 1 || Bb > 65535 || hg < 1 || nh % hg != 0 || (S + Q - 1) / Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* init = static_cast<const float*>(init_state);
  float* fin = static_cast<float*>(final_state);
  float* cs = static_cast<float*>(chunk_state);
  float* sg = static_cast<float*>(seg);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, dtf, Af, Bm, Cm, init, y, fin, cs, sg, h_in, Bb, S,
                        nh, hp, N, hg, s);
  } else if (dtype == 1) {
    err = launch<bf16>(x, dtf, Af, Bm, Cm, init, y, fin, cs, sg, h_in, Bb, S,
                       nh, hp, N, hg, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
