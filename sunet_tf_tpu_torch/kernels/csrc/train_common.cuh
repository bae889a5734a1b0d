// Shared pieces of the training kernels (the block backward and the LN+W-MSA
// and LN+MLP backwards on block_bwd_hopper.cuh, the x4 head's backwards on
// up4_bwd.cuh, the token-row GEMM of gemm_tile.cuh): the token-index map
// of a window-major (rolled, partitioned) token order, launch-status
// helpers, the workspace carver, GELU and its derivative, and the LayerNorm
// row kernel (#4's first launch, any C: C=1440 in the scaled config).
//
// Kernels defined here are static, so every source that includes the
// header gets its own copy and the link sees no duplicates.
//
// Weight gradients are dW = A^T dB over every token of the batch. The TPU
// kernels carry these sums across their sequential grid; here the CTAs run
// in parallel, so each CTA sums a fixed chunk of tokens into its own
// partial and a later launch adds the partials in chunk order: no atomics,
// the same bits on every run.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace sunet {

// Element offset of window-major token t in an NHWC map rolled by -shift:
// t = ((b*nW + win)*N + n); token n of window win sits at image row
// (wy*ws + n/ws + shift) % H and column (wx*ws + n%ws + shift) % W.
__device__ inline size_t token_offset(int t, int H, int W, int C, int ws, int shift) {
  const int N = ws * ws, hw = H * W, nwx = W / ws;
  const int b = t / hw, r = t % hw, win = r / N, n = r % N;
  const int gy = ((win / nwx) * ws + n / ws + shift) % H;
  const int gx = ((win % nwx) * ws + n % ws + shift) % W;
  return (((size_t)b * H + gy) * W + gx) * C;
}

#define SUNET_TRY(expr)               \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// After a raw <<<>>> launch: count it and return its status.
inline cudaError_t launched(int* launches) {
  ++*launches;
  return cudaGetLastError();
}

// Bump allocator over one device workspace (128-byte aligned pieces).
struct Carve {
  unsigned char* p;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p ? p + used : nullptr);
    used += align128(n * sizeof(T));
    return r;
  }
};

// ---- row kernels

constexpr int kLnRows = 64;    // rows per CTA of the row kernels (8 per warp)
constexpr int kLnMaxC = 768;   // widest LayerNorm row of the training kernels

inline int ln_ctas(int T) { return (T + kLnRows - 1) / kLnRows; }

__device__ inline float gelu_f(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }
__device__ inline float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// LayerNorm of T rows: src rows (gathered from the NHWC map by
// token_offset when `gather`, else src's own rows), copy (gather only)
// keeps the gathered rows, out = round(xhat * g + b), stats = (mean, inv)
// per row. Every caller takes src's own rows; the kernel keeps the gather
// because the same kernel without it ran slower on the H100 (#4 0.067
// against 0.063 ms at (8,8,768), PERF.md).
static __global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const bf16* __restrict__ src, bool gather, bf16* __restrict__ copy,
                  bf16* __restrict__ out, float* __restrict__ stats, const float* __restrict__ g,
                  const float* __restrict__ b, int T, int C, int H, int W, int ws, int shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < kLnRows / kWarps; ++i) {
    const int r = blockIdx.x * kLnRows + warp * (kLnRows / kWarps) + i;
    if (r >= T) return;
    const bf16* s = gather ? src + token_offset(r, H, W, C, ws, shift) : src + (size_t)r * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += bf(s[c]);
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = bf(s[c]) - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) {
      const bf16 v = s[c];
      if (copy) copy[(size_t)r * C + c] = v;
      out[(size_t)r * C + c] = tobf((bf(v) - mean) * inv * g[c] + b[c]);
    }
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = inv;
    }
  }
}

inline cudaError_t ln_fwd(const bf16* src, bool gather, bf16* copy, bf16* out, float* stats,
                          const float* g, const float* b, int T, int C, int H, int W, int ws,
                          int shift, cudaStream_t st, int* launches) {
  ln_fwd_kernel<<<ln_ctas(T), kThreads, 0, st>>>(src, gather, copy, out, stats, g, b, T, C, H,
                                                 W, ws, shift);
  return launched(launches);
}

}  // namespace sunet
