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
// accumulator in registers. The products are tiled_matmul.cuh's: bf16 x on
// mma.sync, fp32 x as exact FMA. Any M, N, K, masked at the edges: the
// reference's 128-multiple assert is a TPU tiling artefact, and real
// capacities are not multiples of 128 (granite-moe's 1024-token capacity is
// 320). x carries its own expert stride and row stride: the MoE decode sets
// the expert stride to 0, so every expert reads the same rows of one
// (M, K) buffer and no copy per expert is made.
//
// Two routes, one per place w lives:
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
// (33.5 MB for one of granite-moe's bf16 stacks, about 0.6 ms at 55 GB/s),
// against which the products of a decode step (M = slots) are free. With w
// on the device, HBM for small M (every expert's w read once, the MoE
// decode) and the tensor cores for a prefill's capacity buffers.
#include <algorithm>

#include "tiled_matmul.cuh"

// the kernels' route tags (tiled_matmul.cuh): w on the device, w streamed
struct gmm_resident;
struct gmm_pinned;

namespace {

// Copy rows [k0, k0 + kb) of experts [e0, e0 + ne) of w into ring slot dst,
// densely: (ne, kb, N).
cudaError_t copy_panel(void* dst, const void* w, long long swe, long long ldw,
                       size_t es, int N, int K, int e0, int ne, int k0, int kb,
                       cudaStream_t s) {
  const char* src = static_cast<const char*>(w) +
                    (static_cast<size_t>(e0) * swe +
                     static_cast<size_t>(k0) * ldw) * es;
  char* d = static_cast<char*>(dst);
  const size_t rows_bytes = static_cast<size_t>(kb) * N * es;
  if (ldw == N && (ne == 1 || (kb == K && swe == static_cast<long long>(K) * N)))
    return cudaMemcpyAsync(d, src, ne * rows_bytes, cudaMemcpyHostToDevice, s);
  for (int i = 0; i < ne; ++i) {
    cudaError_t err = cudaMemcpy2DAsync(
        d + i * rows_bytes, N * es, src + static_cast<size_t>(i) * swe * es,
        static_cast<size_t>(ldw) * es, N * es, kb, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// out (E, M, N), dense, in x's type = x @ w per expert. dtypes: 0 = float32,
// 1 = bfloat16. x[e] starts at x + e * sxe with row stride ldx (sxe = 0:
// one x for every expert); w[e] at w + e * swe with row stride ldw, unit
// column stride. w_on_host = 0: w is device memory, one launch. w_on_host =
// 1: w is pinned host memory and is streamed in panels of panel_experts x
// panel_k x N elements through ring (two such panels of device memory); acc
// is an (M, N) fp32 scratch buffer, needed when panel_k < K (then
// panel_experts must be 1). Launches on `stream` and does not synchronise.
// Returns the CUDA error code (0 = launched).
extern "C" int grouped_matmul(const void* x, long long sxe, long long ldx,
                              int x_dtype, const void* w, long long swe,
                              long long ldw, int w_dtype, int w_on_host,
                              void* ring, float* acc, void* out, int E, int M,
                              int N, int K, int panel_experts, int panel_k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || E <= 0 ||
      M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!w_on_host)
    return static_cast<int>(launch_product<gmm_resident>(
        Operand{x, ldx, sxe, x_dtype}, Operand{w, ldw, swe, w_dtype}, 0,
        nullptr, out, E, M, N, K, 0, 1, s));

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
    return copy_panel(slot, w, swe, ldw, es, N, K, p.e0, p.ne, p.k0, p.kb, cs);
  };
  auto product = [&](int j, const void* slot) {
    const Panel p = panel(j);
    const char* xp = static_cast<const char*>(x) +
                     (static_cast<size_t>(p.e0) * sxe + p.k0) * xs;
    char* op = static_cast<char*>(out) + static_cast<size_t>(p.e0) * M * N * xs;
    return launch_product<gmm_pinned>(
        Operand{xp, ldx, sxe, x_dtype},
        Operand{slot, N, static_cast<long long>(p.kb) * N, w_dtype}, 0, acc,
        op, p.ne, M, N, p.kb, p.k0 > 0, p.k0 + p.kb == K, s);
  };
  return static_cast<int>(stream_panels(
      w, panels, ring,
      static_cast<size_t>(panel_experts) * panel_k * N * es, s, copy,
      product));
}

extern "C" const char* grouped_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
