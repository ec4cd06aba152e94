// Streaming matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/stream_matmul.py::stream_matmul (body _stream_kernel).
//
// Computes out = x @ w over (M, K) x (K, N): an fp32 accumulator, K innermost,
// the result in x's type. w may be of another type than x; each w value is
// converted to x's type (or to fp32) after it is loaded, as the reference
// casts w before the product, so w's bytes cross the host link in w's own
// type. w is either (K, N) row-major ("kn") or (N, K) row-major ("nk", the
// tied unembedding's tok_embed.T), each with its own leading dimension. Any
// M, N, K: the reference's divisibility assert is a TPU tiling artefact, and
// a decode step has M = the number of slots.
//
// Two routes; the caller's plan (kernels/stream_matmul.py::plan) picks one
// from where w lives:
//
//  * resident (w in device memory): one launch of tiled_matmul.cuh's
//    products over the whole K, batch 1 (wgmma for bf16 operands a TMA
//    descriptor takes).
//  * ring (w in pinned host memory): the reference's structure, for real.
//    Panels of w are copied by the copy engine into a two-panel device ring
//    on a side stream; the product of panel j runs on the caller's stream
//    while panel j + 1 is in flight, ordered by events (tiled_matmul.cuh's
//    stream_panels), on tiled_matmul.cuh's products (wgmma where TMA takes
//    the operands). A panel is a contiguous slab of the host tensor, one
//    linear copy: for "kn" block rows of K (all of N), whose products
//    accumulate into one fp32 buffer, the last one writing the output; for
//    "nk" block rows of the table (output columns, all of K), each product
//    complete, placed into its columns of the output by a device copy. Every
//    byte of w crosses the link exactly once per call, whatever M is. The
//    plan sizes a panel by bytes (about 32 MB): each panel costs host work
//    to issue and a drain of the copy engine's pipeline, so a decode's tiny
//    products favour deep panels, while a prefill's last product, the one no
//    copy hides, favours shallow ones.
//
// The paper's other mechanism, direct access (the SMs loading w from pinned
// host memory mapped into the card's address space, one launch and no
// staging), was built and measured here and lost: on this card's PCIe host
// the SMs' reads of host memory (plain loads, with the L2 256-byte hint, or
// TMA bulk copies) reach about three fifths of the copy engine's rate, and
// sharing the bytes between the two slows the link down (PERF.md).
//
// What bounds it. With w on the host, the host link: K*N*sizeof(w) bytes
// (117.4 MB for one 4096 x 14336 bf16 matrix, 1.86 ms at PCIe Gen5 x16's
// 63.0 GB/s). Against that a decode step's products (M = 4) are free and a
// 1024-token prefill's (120 GFLOP, ~0.2 ms on wgmma) fit under the copies.
// With w on the device, HBM for small M (w read once) and the tensor cores
// for large M.
#include <algorithm>

#include "tiled_matmul.cuh"

// the kernels' route tags (tiled_matmul.cuh): w on the device, w streamed
struct stream_resident;
struct stream_pinned;

namespace {

// Copy rows [r0, r0 + rows) of w's slab (K rows of N for "kn", N table rows
// of K for "nk"; row stride ldw, each row `cols` elements) into ring slot
// dst, densely.
cudaError_t copy_panel(void* dst, const void* w, long long ldw, size_t es,
                       int cols, int r0, int rows, cudaStream_t s) {
  const char* src = static_cast<const char*>(w) +
                    static_cast<size_t>(r0) * static_cast<size_t>(ldw) * es;
  if (ldw == cols)
    return cudaMemcpyAsync(dst, src, static_cast<size_t>(rows) * cols * es,
                           cudaMemcpyHostToDevice, s);
  return cudaMemcpy2DAsync(dst, cols * es, src, static_cast<size_t>(ldw) * es,
                           cols * es, rows, cudaMemcpyHostToDevice, s);
}

}  // namespace

// out (M, N) = x (M, K) @ w, in x's type. dtypes: 0 = float32, 1 = bfloat16.
// w_nk = 0: w is (K, N) with row stride ldw; 1: w is (N, K) with row stride
// ldw. route 0 (resident): w is device memory, one launch of the product
// kernel `product` (1: wgmma on a tile x tile output tile; 0: mma.sync for
// bf16 x, FMA for fp32 x). route 1 (ring): w is pinned host memory streamed
// by the copy engine in panels of `panel` rows of its slab (K rows for "kn",
// table rows for "nk") through ring (min(2, panels) * panel * row bytes of
// device memory), each panel's product as route 0's. acc: with more than one
// panel, an (M, N) fp32 scratch buffer ("kn": the partial sums; "nk": a
// panel's output before it is placed). Launches on `stream` and does not
// synchronise. Returns the CUDA error code (0 = launched).
extern "C" int stream_matmul(const void* x, long long ldx, int x_dtype,
                             const void* w, long long ldw, int w_dtype,
                             int w_nk, int route, int product, int tile,
                             void* ring, float* acc, void* out, int M, int N,
                             int K, int panel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || M <= 0 ||
      N <= 0 || K <= 0 || route < 0 || route > 1 || product < 0 || product > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // x has batch stride 0 (wgmma reads it through a 2-D map); w's is the
  // matrix's size, which a TMA map takes and a batch of one never steps
  const long long w_rows = w_nk ? N : K;
  if (route == 0)
    return static_cast<int>(launch_planned<stream_resident>(
        product, tile, tile, Operand{x, ldx, 0, x_dtype},
        Operand{w, ldw, w_rows * ldw, w_dtype}, w_nk, nullptr, out, 1, M, N,
        K, 0, 1, s));

  const int cols = w_nk ? K : N;   // elements of one slab row
  if (panel <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int panels = static_cast<int>((w_rows + panel - 1) / panel);
  if (panels > 1 && acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t xs = elem_size(x_dtype);
  const size_t es = elem_size(w_dtype);
  auto copy = [&](int j, void* slot, cudaStream_t cs) {
    const int r0 = j * panel;
    return copy_panel(slot, w, ldw, es, cols,
                      r0, std::min<long long>(panel, w_rows - r0), cs);
  };
  auto run = [&](int j, const void* slot) {
    const int r0 = j * panel;
    const int rows = static_cast<int>(std::min<long long>(panel, w_rows - r0));
    if (!w_nk)
      return launch_planned<stream_pinned>(
          product, tile, tile,
          Operand{static_cast<const char*>(x) + r0 * xs, ldx, 0, x_dtype},
          Operand{slot, N, static_cast<long long>(rows) * N, w_dtype}, 0, acc,
          out, 1, M, N, rows, j > 0, j == panels - 1, s);
    // output columns r0 .. r0 + rows: straight into out when there is one
    // panel, else through acc's memory into their place
    void* dst = panels == 1 ? out : static_cast<void*>(acc);
    cudaError_t err = launch_planned<stream_pinned>(
        product, tile, tile, Operand{x, ldx, 0, x_dtype},
        Operand{slot, K, static_cast<long long>(rows) * K, w_dtype}, 1,
        nullptr, dst, 1, M, rows, K, 0, 1, s);
    if (err != cudaSuccess || panels == 1) return err;
    return cudaMemcpy2DAsync(static_cast<char*>(out) + r0 * xs, N * xs, dst,
                             rows * xs, rows * xs, M, cudaMemcpyDeviceToDevice,
                             s);
  };
  return static_cast<int>(stream_panels(
      w, panels, ring, static_cast<size_t>(std::min<long long>(panel, w_rows)) * cols * es,
      s, copy, run));
}

extern "C" const char* stream_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
