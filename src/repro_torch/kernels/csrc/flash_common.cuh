// Tile helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) and the mma.sync pieces ssd_scan.cu takes from
// here. Header only; kernels/_build.py hashes it into every library, so an
// edit rebuilds all of them.
//
// fp32 tiles live in shared memory as float with pitch HD + 4 (the bf16
// kernels' tiles are TMA's, hopper.cuh). Every load moves 16 bytes a thread;
// rows past rows_valid read as zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

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

// ROWS rows of HD elements from device memory into an fp32 tile, each value
// multiplied by mul.
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int rows_valid, float mul) {
  constexpr int EPV = Elem<T>::PER_VEC;
  constexpr int VPR = HD / EPV;
  constexpr int PITCH = HD + 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
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

template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void store_tile(T* dst, const float* src,
                                           int rows_valid) {
  constexpr int EPV = Elem<T>::PER_VEC;
  constexpr int VPR = HD / EPV;
  constexpr int PITCH = HD + 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
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

// ---------------------------------------------------------------------------
// tensor cores: mma.sync m16n8k16, bf16 in, fp32 accumulate
// ---------------------------------------------------------------------------
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

}  // namespace flash
