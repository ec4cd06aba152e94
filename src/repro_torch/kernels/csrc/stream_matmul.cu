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
// The products are tiled_matmul.cuh's (one product, batch 1).
#include <algorithm>

#include "tiled_matmul.cuh"

// the kernels' route tags (tiled_matmul.cuh): w on the device, w streamed
struct stream_resident;
struct stream_pinned;

namespace {

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
  if (!w_on_host)
    return static_cast<int>(launch_product<stream_resident>(
        Operand{x, ldx, 0, x_dtype}, Operand{w, ldw, 0, w_dtype}, w_nk, acc,
        out, 1, M, N, K, 0, 1, s));

  const int panels = (K + block_k - 1) / block_k;
  if (panels > 1 && acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t xs = elem_size(x_dtype);
  const size_t es = elem_size(w_dtype);
  auto copy = [&](int j, void* slot, cudaStream_t cs) {
    const int k0 = j * block_k;
    return copy_panel(slot, w, ldw, w_nk, es, N, k0, std::min(block_k, K - k0),
                      cs);
  };
  auto product = [&](int j, const void* slot) {
    const int k0 = j * block_k;
    const int kb = std::min(block_k, K - k0);
    return launch_product<stream_pinned>(
        Operand{static_cast<const char*>(x) + k0 * xs, ldx, 0, x_dtype},
        Operand{slot, w_nk ? kb : N, 0, w_dtype}, w_nk, acc, out, 1, M, N, kb,
        j > 0, j == panels - 1, s);
  };
  return static_cast<int>(stream_panels(
      w, panels, ring, static_cast<size_t>(std::min(block_k, K)) * N * es, s,
      copy, product));
}

extern "C" const char* stream_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
