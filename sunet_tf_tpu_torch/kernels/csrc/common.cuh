// Shared pieces of the SUNet Hopper kernels: sizes and alignment, warp
// reductions, bf16 conversions and packing, and the mma.sync tile of the
// per-(window, head) attention kernels. kThreads: the 8-warp CTA of the
// row kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sunet {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Shared-memory matrices pad each row by 16 bytes (8 bf16, 4 floats): with
// row strides that are multiples of 128 bytes, the 8 rows an ldmatrix phase
// reads would all fall in the same banks.
constexpr int kPad = 8;
constexpr int kPadF = 4;
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory per block (H100)

__host__ __device__ inline int align_up(int v, int a) { return (v + a - 1) / a * a; }
__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float bf(bf16 v) { return __bfloat162float(v); }
__device__ inline bf16 tobf(float v) { return __float2bfloat16(v); }

// Two bf16 (lo, hi) in one 32-bit register, and a 32-bit load of two.
__device__ inline uint32_t pack_bf2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(tobf(lo)) |
         ((uint32_t)__bfloat16_as_ushort(tobf(hi)) << 16);
}
__device__ inline uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// d (16x8 fp32) += a (16x16 bf16, row) @ b (16x8 bf16, col): the mma.sync
// tile of the per-(window, head) attention kernels (#1, #3, the block
// backward).
__device__ inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class Kernel>
inline cudaError_t set_smem(Kernel k, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sunet
