// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/flash_attention.py::flash_attention_fwd (body _flash_kernel)
//   and ::flash_attention_fwd_stats (body _flash_stats_kernel).
//
// Computes O = softmax(Q K^T * scale + mask) V over (BH, S, hd) by online
// softmax: running row max m, row sum l and an fp32 accumulator, the mask
// value NEG_INF = -1e30 kept finite, the result acc / max(l, 1e-30). When the
// caller passes an lse pointer (training), the epilogue also writes the row
// statistics the backward needs, lse = m + log(max(l, 1e-30)) in fp32, as
// _flash_stats_kernel adds to _flash_kernel; serving passes nullptr.
//
// What differs from the TPU kernel. There the grid's innermost KV axis runs in
// order on one core and m / l / acc live in VMEM scratch between grid steps.
// Here thread blocks run in parallel and share nothing, so one block owns one
// (bh, query tile) and walks the 64-row KV tiles in a loop of its own, with
// m, l and acc in registers. KV tiles wholly above the diagonal are never
// visited. The ragged edge (S not a multiple of the tile) is masked here:
// rows past Sq are not stored, columns past Sk score NEG_INF.
//
// The causal mask takes a query offset: row i is at position i + q_offset
// and sees keys 0 .. i + q_offset, so the diagonal, the last tile a block
// visits and the masked tiles all move right by q_offset. A rank of a
// sequence-parallel mesh passes its query block's first position over the
// whole sequence's keys; q_offset = 0 is the plain causal mask.
//
// What bounds it. At the serving path's shapes (hd = 128, S up to 1024) the
// function needs 4*BH*S*hd*itemsize bytes and about 2*BH*S^2*hd operations
// when causal: bytes and operations bound it about equally in bf16, and
// operations alone in fp32 (67 TFLOP/s outside the tensor cores). What the
// design does about it, one kernel per input type:
//
//  * bf16 — flash_fwd_wgmma_kernel: 128 query rows a block on two consumer
//    warpgroups, both products on wgmma (fp32 accumulate), fed by a TMA
//    ring of K and V tiles that a producer warp keeps loading while the
//    warpgroups compute; probabilities stay in registers as the A operand of
//    the second product, rounded to bf16, and V is read MN-major as TMA
//    laid it down. What still bounds it: inside a warpgroup the softmax and
//    the two products run one after the other (no ping-pong of the two
//    warpgroups, no intra-warpgroup overlap), and the output leaves through
//    4-byte stores.
//  * fp32 — flash_fwd_kernel: fp32 FMA on the CUDA cores, so the products are
//    exact fp32 (no TF32). Each thread keeps a 4x4 tile of scores and a
//    4 x hd/16 tile of the output in registers so every shared-memory load
//    feeds 4 or more FMAs; K and V share one staging buffer so that two
//    blocks fit on an SM and one computes while the other loads. 64 query
//    rows a block; loads and products do not overlap inside a block.
//
// Both schedule the heaviest (last) query tiles first.
//
// Inputs fp32 or bf16, head dim 16, 32, 64, 96 or 128, output in the input
// type. Head dim 96 (phi3-mini) is a case of both kernels: the fp32 one keeps
// six output columns a thread, the bf16 one stores each 192-byte row as
// three 64-byte-swizzled chunks (hopper::swizzle_bytes), so QK^T takes six
// 32-byte k-steps and P V one m64n96k16 wgmma a k-step, V's three chunks
// spanned by one MN-major descriptor.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::NEG_INF;
using flash::pack_bf16;

constexpr int BM = 64;           // query rows per block
constexpr int BN = 64;           // kv rows per tile
constexpr int TX = 16;           // threads across score columns
constexpr int TY = 16;           // threads across query rows
constexpr int NT = TX * TY;      // 256 threads
constexpr int RPT = BM / TY;     // query rows per thread
constexpr int CPT = BN / TX;     // score columns per thread
constexpr int PP = BN + 4;       // pitch of the probability tile

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int BH, int Sq, int Sk, int causal,
                 int q_offset, float scale) {
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

  flash::load_tile<T, HD, BM, NT>(Qs, qb, q_valid, scale);

  float m[RPT], l[RPT], acc[RPT][OC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int nkv = (Sk + BN - 1) / BN;
  if (causal) nkv = min(nkv, (q0 + q_offset + BM - 1) / BN + 1);

  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * BN;
    const int k_valid = min(BN, Sk - k0);

    __syncthreads();  // the previous tile's V is no longer read
    flash::load_tile<T, HD, BN, NT>(KVs, kb + static_cast<size_t>(k0) * HD, k_valid, 1.f);
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
        const bool keep = (col < Sk) && (!causal || row + q_offset >= col);
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
    flash::load_tile<T, HD, BN, NT>(KVs, vb + static_cast<size_t>(k0) * HD, k_valid, 1.f);
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
  flash::store_tile<T, HD, BM, NT>(ob, Qs, q_valid);
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      if (row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Sq, int Sk, int causal, int q_offset,
                   float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, BH, Sq, Sk, causal,
      q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: wgmma on a TMA-fed ring. One block owns 128 query rows of one
// (batch, head), two consumer warpgroups of 64 rows each, and a producer
// warp. The producer loads the Q tile once, then K and V tiles of 64 rows
// into a ring of WSTAGES stages, each tile completing its own mbarrier, so
// that the next tile's loads overlap this tile's products and softmax. Per
// tile a warpgroup runs S = Q K^T (wgmma, Q and K K-major in shared memory),
// the online softmax on the accumulators, and O += P V (wgmma with P, rounded
// to bf16, as the register A operand straight from S's accumulator layout,
// and V read MN-major through the transpose bit: no transposed copy); then
// each of its warps hands the stage back on the stage's empty barrier.
//
// A causal warpgroup stops at its own 64 rows' diagonal; the two
// warpgroups of a block differ by at most the block's last tile, which the
// producer never waits to refill, so the one that stops early owes that
// tile no arrival.
// ---------------------------------------------------------------------------
constexpr int WQ = 128;                // query rows per block
constexpr int WKV = 64;                // kv rows per tile
constexpr int WSTAGES = 2;             // K / V stages in the ring
constexpr int WT = 2 * 128 + 32;       // two consumer warpgroups + a producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct FwdTile {
  static constexpr int SW = hopper::swizzle_bytes(HD * 2);  // swizzle: bytes a row of a chunk
  static constexpr int CH = HD * 2 / SW;                     // column chunks
  static constexpr int BOX = SW / 2;                        // elements a TMA box row
  static constexpr int Q_BYTES = WQ * HD * 2;
  static constexpr int KV_BYTES = WKV * HD * 2;             // one K or one V tile
  static constexpr int SMEM = Q_BYTES + 2 * WSTAGES * KV_BYTES + 1024;
};

// qmap (HD, Sq, BH), kmap and vmap (HD, Sk, BH): bf16, boxes of (BOX, WQ, 1)
// and (BOX, WKV, 1), swizzled SW bytes; one box per column chunk.
template <int HD>
__global__ void __launch_bounds__(WT)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int BH, int Sq, int Sk, int causal, int q_offset,
                       float scale_log2) {
  using T = FwdTile<HD>;
  constexpr int SW = T::SW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar, kfull[WSTAGES], vfull[WSTAGES],
      empty[WSTAGES];
  unsigned char* Qs = hopper::align1024(smem_raw);   // chunk c of row r: c*WQ*SW + r*SW
  unsigned char* Ks = Qs + T::Q_BYTES;       // stage s: s*KV_BYTES, chunks WKV*SW apart
  unsigned char* Vs = Ks + WSTAGES * T::KV_BYTES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nq = (Sq + WQ - 1) / WQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * WQ;
  const int nkv = (Sk + WKV - 1) / WKV;
  // KV tiles warpgroup g reads: a causal one stops at its rows' diagonal
  auto tiles_of = [&](int g) {
    return causal ? min(nkv, (q0 + q_offset + 64 * g + 63) / WKV + 1) : nkv;
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(&qbar, 1);
    for (int s = 0; s < WSTAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 8);   // lane 0 of every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: the tiles either warpgroup reads; stage t % WSTAGES is
    // refilled once both released its previous use, t - WSTAGES
    if (lane == 0) {
      const int ntiles = tiles_of(1);
      hopper::mbar_expect_tx(&qbar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CH; ++c)
        hopper::tma_load_3d(Qs + c * WQ * SW, &qmap, &qbar, c * T::BOX, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % WSTAGES;
        if (t >= WSTAGES) hopper::mbar_wait(&empty[s], ((t / WSTAGES) - 1) & 1);
        hopper::mbar_expect_tx(&kfull[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CH; ++c)
          hopper::tma_load_3d(Ks + s * T::KV_BYTES + c * WKV * SW, &kmap,
                              &kfull[s], c * T::BOX, t * WKV, bh);
        hopper::mbar_expect_tx(&vfull[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CH; ++c)
          hopper::tma_load_3d(Vs + s * T::KV_BYTES + c * WKV * SW, &vmap,
                              &vfull[s], c * T::BOX, t * WKV, bh);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64 g .. + 63; each thread
  // rows r (half 0) and r + 8 (half 1) of its warp's 16
  const int g = warp >> 2;
  const int r = q0 + 64 * g + (warp & 3) * 16 + (lane >> 2);
  const int tq = lane & 3;
  const int ntiles = tiles_of(g);
  float m[2] = {NEG_INF, NEG_INF};   // running max, log2 units
  float l[2] = {0.f, 0.f};
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  hopper::mbar_wait(&qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % WSTAGES;
    const uint32_t par = (t / WSTAGES) & 1;
    const int k0 = t * WKV;

    // S = Q K^T: 64 rows x 64 keys, HD / 16 k-steps of 32 bytes
    float sacc[WKV / 2];
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) sacc[i] = 0.f;
    hopper::mbar_wait(&kfull[s], par);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 32 / SW, off = kk * 32 % SW;
      const uint64_t da = hopper::make_desc(Qs + c * WQ * SW + g * 64 * SW + off,
                                            16, 8 * SW, SW);
      const uint64_t db = hopper::make_desc(
          Ks + s * T::KV_BYTES + c * WKV * SW + off, 16, 8 * SW, SW);
      hopper::wgmma_ss<0>(sacc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);

    // scale (to log2 units), mask, online softmax; a row is one thread's 16
    // values and its quad's
    const bool masked = k0 + WKV > Sk || (causal && k0 + WKV - 1 > q0 + q_offset + 64 * g);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < WKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + (i >> 1) * 8;
        const int col = k0 + j * 8 + 2 * tq + (i & 1);
        const bool keep = !masked || ((col < Sk) && (!causal || row + q_offset >= col));
        const float v = keep ? sacc[4 * j + i] * scale_log2 : NEG_INF;
        sacc[4 * j + i] = v;
        mx[i >> 1] = fmaxf(mx[i >> 1], v);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < WKV / 2; ++i) {
      sacc[i] = exp2f(sacc[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

    // O += P V: the accumulators of two neighbouring 8-key groups, rounded
    // to bf16, are the A fragment of one 16-key k-step
    uint32_t pa[WKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    hopper::mbar_wait(&vfull[s], par);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk) {
      // 16 kv rows of SW bytes; the column chunks WKV * SW bytes apart
      const uint64_t db = hopper::make_desc(
          Vs + s * T::KV_BYTES + kk * 16 * SW, WKV * SW, 8 * SW, SW);
      hopper::wgmma_rs<1>(oacc, pa[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);
    hopper::fence_frags(pa);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // normalise and store: row r (+ 8), columns 8 j + 2 tq, + 1
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = o + (static_cast<size_t>(bh) * Sq + row) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(oacc[4 * j + 2 * h] * inv[h], oacc[4 * j + 2 * h + 1] * inv[h]);
    if (lse != nullptr && tq == 0)
      lse[static_cast<size_t>(bh) * Sq + row] =
          m[h] * LN2 + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int BH, int Sq, int Sk, int causal,
                         int q_offset, float scale, cudaStream_t stream) {
  using T = FwdTile<HD>;
  const long long blocks =
      static_cast<long long>((Sq + WQ - 1) / WQ) * static_cast<long long>(BH);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {HD, static_cast<uint64_t>(Sq), static_cast<uint64_t>(BH)};
  const uint64_t kdims[3] = {HD, static_cast<uint64_t>(Sk), static_cast<uint64_t>(BH)};
  const uint64_t qstr[2] = {HD, static_cast<uint64_t>(Sq) * HD};
  const uint64_t kstr[2] = {HD, static_cast<uint64_t>(Sk) * HD};
  const uint32_t qbox[3] = {T::BOX, WQ, 1};
  const uint32_t kbox[3] = {T::BOX, WKV, 1};
  cudaError_t err;
  if ((err = hopper::make_map(&qmap, q, 3, qdims, qstr, qbox)) != cudaSuccess ||
      (err = hopper::make_map(&kmap, k, 3, kdims, kstr, kbox)) != cudaSuccess ||
      (err = hopper::make_map(&vmap, v, 3, kdims, kstr, kbox)) != cudaSuccess)
    return err;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  static int allowed[hopper::MAX_DEVICES] = {};   // this kernel's, by device
  if ((err = hopper::allow_smem(kern, T::SMEM, allowed)) != cudaSuccess)
    return err;
  kern<<<dim3(static_cast<unsigned>(blocks)), dim3(WT), T::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, BH, Sq, Sk,
      causal, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

// fp32 inputs take the FMA kernel (exact fp32 products), bf16 inputs the
// tensor-core kernel.
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int BH, int Sq, int Sk, int causal,
                        int q_offset, float scale, cudaStream_t stream) {
#define FLASH_CASE(HD_)                                                        \
  case HD_:                                                                    \
    if constexpr (sizeof(T) == 2)                                              \
      return launch_wgmma<HD_>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset, \
                               scale, stream);                                   \
    else                                                                       \
      return launch<T, HD_>(q, k, v, o, lse, BH, Sq, Sk, causal, q_offset,    \
                            scale, stream);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous (BH, S, hd); lse
// is a contiguous fp32 (BH, Sq) output, or nullptr when not wanted. Causal
// with q_offset >= 0: query row i is at position i + q_offset and sees keys
// 0 .. i + q_offset (q_offset = Sk - Sq aligns the last query with the last
// key). Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int BH, int Sq, int Sk,
                                   int hd, int dtype, int causal, int q_offset,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_hd<float>(hd, q, k, v, o, lse, BH, Sq, Sk, causal, q_offset,
                             scale, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, BH, Sq, Sk, causal,
                                     q_offset, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
