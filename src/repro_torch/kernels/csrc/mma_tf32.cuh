// Device helpers shared by the CUDA kernels that multiply in float32 on
// the tensor cores (ssd.cu, wkv6.cu): cp.async copies and mma.sync
// m16n8k8 TF32 in three passes (3xTF32), which keeps float32 accuracy.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// v = hi + lo exactly: hi is v cut to TF32's 10 fraction bits, lo the
// rest, handed to the tensor core as it is (it reads its TF32 part)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its two TF32 parts.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2,
                                      float v3) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
    split(v2, hi[2], lo[2]);
    split(v3, hi[3], lo[3]);
  }
};

// c += a * b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, a.lo, h0, h1);
  mma_tf32(c, a.hi, l0, l1);
  mma_tf32(c, a.hi, h0, h1);
}

// Fragment layouts of m16n8k8 TF32 (g = lane / 4, c = lane % 4): A holds
// (row g, col c), (g + 8, c), (g, c + 4), (g + 8, c + 4); B (k c, n g),
// (k c + 4, n g); an fp32 accumulator (g, 2c), (g, 2c + 1), (g + 8, 2c),
// (g + 8, 2c + 1).

// c += a * b in three TF32 passes, b given split
__device__ __forceinline__ void mma3_split(float (&c)[4], const FragA& a,
                                           float2 bhi, float2 blo) {
  const uint32_t h0 = __float_as_uint(bhi.x), h1 = __float_as_uint(bhi.y);
  mma_tf32(c, a.lo, h0, h1);
  mma_tf32(c, a.hi, __float_as_uint(blo.x), __float_as_uint(blo.y));
  mma_tf32(c, a.hi, h0, h1);
}

}  // namespace
