// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/moe_gmm.py::grouped_matmul (body _gmm_kernel).
//
// Computes out[e] = x[e] @ w[e] over (E, M, K) x (E, K, N) -> (E, M, N): an
// fp32 accumulator, K innermost, the result in x's type. On the TPU the grid
// is (E, C/bc, f/bf, d/bd) with the contraction innermost and sequential and
// the accumulator in VMEM scratch; here one block owns an (e, M-tile,
// N-tile) output block (blockIdx.z = e) and loops over K itself with the
// accumulator in registers. Any M, N, K, masked at the edges: the
// reference's 128-multiple assert is a TPU tiling artefact, and real
// capacities are not multiples of 128 (granite-moe's 1024-token capacity is
// 320). x carries its own expert stride and row stride: the MoE decode sets
// the expert stride to 0, so every expert reads the same rows of one
// (M, K) buffer and no copy per expert is made. w is (K, N) row-major per
// expert ("kn") or (N, K) ("nk"), read as it lies. x may also be given as
// its transpose (x_t: (K, M) rows with M contiguous), the backward's
// dw[e] = x[e]^T dy[e] on the (E, C, d) capacity buffer as it lies, on the
// wgmma route only (A's transpose bit), with w "kn" on the device.
//
// The products are tiled_matmul.cuh's, on the route the caller's plan
// names (kernels/grouped_matmul.py::plan, by a shape and alignment rule):
//
//  * route 1, wgmma: bf16 x and w whose bases are 16-byte aligned and whose
//    strides are multiples of 8 elements (what a TMA descriptor takes). A
//    TMA-fed ring of 4 stages and wgmma on one or two consumer warpgroups;
//    64 x 64 tiles for M <= 64, 128 x 128 above.
//  * route 0: the tiled kernels, mma.sync for any other bf16 x (w in fp32,
//    or an operand TMA cannot take), exact fp32 FMA for fp32 x.
//
// Two placements of w:
//
//  * w in device memory: one launch, all experts.
//  * w in pinned host memory (an expert stack the offload plan spilled): the
//    reference's docstring made real. Panels of w cross the host link into a
//    two-panel device ring on a side stream, and the product of panel j runs
//    on the caller's stream while panel j + 1 is in flight, ordered by
//    events. A panel is panel_experts whole experts when one expert's K rows
//    fit the panel depth, else panel_k rows of one expert; the panels of one
//    expert accumulate into one fp32 (M, N) buffer and the last one writes
//    the output. Every byte of w crosses the link exactly once per call,
//    whatever M is.
//
// What bounds it. With w on the host, the host link: E*K*N*sizeof(w) bytes
// (33.5 MB for one of granite-moe's bf16 stacks, 0.53 ms at the link's
// 63 GB/s peak); a panel's product must take less time than its copy, which
// the wgmma route's 64 x 64 tiles give at decode (M = slots). With w on the
// device, HBM for small M (every expert's w read once, the MoE decode) and
// the tensor cores for a prefill's capacity buffers.
#include <algorithm>

#include "tiled_matmul.cuh"

// the kernels' route tags (tiled_matmul.cuh): w on the device, w streamed
struct gmm_resident;
struct gmm_pinned;

namespace {

// Copy rows [k0, k0 + kb) of K of experts [e0, e0 + ne) of w into ring slot
// dst, densely: (ne, kb, N) for "kn", (ne, N, kb) for "nk".
cudaError_t copy_panel(void* dst, const void* w, long long swe, long long ldw,
                       int w_nk, size_t es, int N, int K, int e0, int ne,
                       int k0, int kb, cudaStream_t s) {
  const char* src = static_cast<const char*>(w) + static_cast<size_t>(e0) * swe * es;
  char* d = static_cast<char*>(dst);
  const size_t panel_bytes = static_cast<size_t>(kb) * N * es;
  if (w_nk) {
    for (int i = 0; i < ne; ++i) {
      cudaError_t err = cudaMemcpy2DAsync(
          d + i * panel_bytes, kb * es,
          src + (static_cast<size_t>(i) * swe + k0) * es,
          static_cast<size_t>(ldw) * es, kb * es, N, cudaMemcpyHostToDevice, s);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  src += static_cast<size_t>(k0) * ldw * es;
  if (ldw == N && (ne == 1 || (kb == K && swe == static_cast<long long>(K) * N)))
    return cudaMemcpyAsync(d, src, ne * panel_bytes, cudaMemcpyHostToDevice, s);
  for (int i = 0; i < ne; ++i) {
    cudaError_t err = cudaMemcpy2DAsync(
        d + i * panel_bytes, N * es, src + static_cast<size_t>(i) * swe * es,
        static_cast<size_t>(ldw) * es, N * es, kb, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// out (E, M, N), dense, in x's type = x @ w per expert. dtypes: 0 = float32,
// 1 = bfloat16. x[e] starts at x + e * sxe with row stride ldx (sxe = 0:
// one x for every expert; x_t = 1: x[e] is stored transposed, (K, M) with
// row stride ldx, route 1 only, w "kn" on the device, sxe not 0); w[e] at
// w + e * swe, (K, N) with row stride ldw (w_nk = 0) or (N, K) with row
// stride ldw (w_nk = 1). route 1: the wgmma kernel on a block_m x block_n
// tile (64 x 64 or 128 x 128); route 0: the tiled kernels (block_m, block_n
// unused). w_on_host = 0: w is device
// memory, one launch. w_on_host = 1: w is pinned host memory and is streamed
// in panels of panel_experts x panel_k x N elements through ring (two such
// panels of device memory); acc is an (M, N) fp32 scratch buffer, needed
// when panel_k < K (then panel_experts must be 1). Launches on `stream` and
// does not synchronise. Returns the CUDA error code (0 = launched).
extern "C" int grouped_matmul(const void* x, long long sxe, long long ldx,
                              int x_dtype, int x_t, const void* w, long long swe,
                              long long ldw, int w_dtype, int w_nk,
                              int w_on_host, int route, int block_m,
                              int block_n, void* ring, float* acc, void* out,
                              int E, int M, int N, int K, int panel_experts,
                              int panel_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || E <= 0 ||
      M <= 0 || N <= 0 || K <= 0 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_t) {
    if (w_on_host || w_nk || route != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma_xt<gmm_resident>(
        Operand{x, ldx, sxe, x_dtype}, Operand{w, ldw, swe, w_dtype}, out, E,
        M, N, K, block_m, block_n, s));
  }
  if (!w_on_host)
    return static_cast<int>(launch_planned<gmm_resident>(
        route, block_m, block_n, Operand{x, ldx, sxe, x_dtype},
        Operand{w, ldw, swe, w_dtype}, w_nk, nullptr, out, E, M, N, K, 0, 1, s));

  if (panel_experts < 1 || panel_k < 1 || panel_k > K ||
      (panel_experts > 1 && panel_k != K) || (panel_k < K && acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t xs = elem_size(x_dtype);
  const size_t es = elem_size(w_dtype);
  const int k_panels = (K + panel_k - 1) / panel_k;
  const int panels = ((E + panel_experts - 1) / panel_experts) * k_panels;
  // panel j: experts from (j / k_panels) * panel_experts, K rows from
  // (j % k_panels) * panel_k
  struct Panel { int e0, ne, k0, kb; };
  auto panel = [&](int j) {
    Panel p;
    p.e0 = (j / k_panels) * panel_experts;
    p.ne = std::min(panel_experts, E - p.e0);
    p.k0 = (j % k_panels) * panel_k;
    p.kb = std::min(panel_k, K - p.k0);
    return p;
  };
  auto copy = [&](int j, void* slot, cudaStream_t cs) {
    const Panel p = panel(j);
    return copy_panel(slot, w, swe, ldw, w_nk, es, N, K, p.e0, p.ne, p.k0,
                      p.kb, cs);
  };
  auto run = [&](int j, const void* slot) {
    const Panel p = panel(j);
    const char* xp = static_cast<const char*>(x) +
                     (static_cast<size_t>(p.e0) * sxe + p.k0) * xs;
    char* op = static_cast<char*>(out) + static_cast<size_t>(p.e0) * M * N * xs;
    return launch_planned<gmm_pinned>(
        route, block_m, block_n, Operand{xp, ldx, sxe, x_dtype},
        Operand{slot, w_nk ? p.kb : N, static_cast<long long>(p.kb) * N,
                w_dtype},
        w_nk, acc, op, p.ne, M, N, p.kb, p.k0 > 0, p.k0 + p.kb == K, s);
  };
  return static_cast<int>(stream_panels(
      w, panels, ring,
      static_cast<size_t>(panel_experts) * panel_k * N * es, s, copy, run));
}

extern "C" const char* grouped_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
