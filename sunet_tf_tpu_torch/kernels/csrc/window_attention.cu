// W-MSA over pre-partitioned windows: qkv with bias, attention, no LayerNorm.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::wmsa_core (its kernel
// _kernel), behind fused_window_attention: from windows xw (T, N, C), T =
// B * nW in image-major order, it writes each (window, head)'s context to a
// (T, N, C) map; the output projection with its bias is then
// ln_window_attention.cu's sunet_linear_bias. Rounding points (the JAX
// kernel's): qkv accumulated in fp32 + bias, rounded; q*scale rounded;
// scores fp32 + rel-pos bias (+ the additive mask of window t % nW); exact
// row-max softmax, P rounded, the divide after P@V; ctx rounded; the
// projection accumulated in fp32 + bias, rounded.
//
// What bounds it on Hopper: at (64,64,96) batch 2 with 8 heads and ws 8 the
// products are 0.8 GFLOP and the bytes 3.2 MB (x in, out, bf16 weights):
// ~1 us, the bytes bound. One window's tokens of one head are small work
// against the q/k/v weights each CTA streams from L2.
//
// Design: common.cuh's attention head (attn_head, as in #1 and #3) with one
// CTA per (window, head), reading the window's rows as they lie (the
// partition is the caller's) into shared memory with no LayerNorm, writing
// that head's ctx columns; then the token-wise projection.
#include "common.cuh"

namespace sunet {

struct WinAttnArgs {
  const bf16* xw;
  bf16* ctx;
  const bf16* wqkv;
  const float* bqkv;
  const float* bias;
  const float* mask;   // (nW, N, N) or null
  int T, nW, N, C, heads;
  float scale;
};

// window rows | head | warps
__host__ __device__ inline size_t win_attn_smem_bytes(int N, int C, int dp) {
  return align128((size_t)N * (C + kPad) * 2) + head_smem_bytes(N, dp) + warp_smem_bytes();
}

__global__ void __launch_bounds__(kThreads) wmsa_ctx_kernel(WinAttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, C = a.C, d = C / a.heads, dp = align_up(d, 16), ldx = C + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem;
  bf16* xs = reinterpret_cast<bf16*>(p);
  p += align128((size_t)N * ldx * 2);
  const HeadSmem hs = carve_head(p, N, dp);
  p += head_smem_bytes(N, dp);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const int t = blockIdx.x, hh = blockIdx.y;
  const size_t base = (size_t)t * N * C;
  const int cv = C / 8;
  for (int i = threadIdx.x; i < N * cv; i += kThreads) {
    const int r = i / cv, c8 = i % cv;
    reinterpret_cast<uint4*>(xs + r * ldx)[c8] =
        __ldg(reinterpret_cast<const uint4*>(a.xw + base + (size_t)r * C) + c8);
  }
  __syncthreads();
  const float* mask = a.mask ? a.mask + (size_t)(t % a.nW) * N * N : nullptr;
  attn_head(xs, ldx, C, N, d, dp, hh, a.wqkv, a.bqkv, a.bias, mask, a.scale, hs, bt, stg, warp,
            lane, [&](int tok, int c, bf16 v) { a.ctx[base + (size_t)tok * C + c] = v; });
}

}  // namespace sunet

using namespace sunet;

// ctx (T, N, C) of every (window, head); the projection is sunet_linear_bias.
extern "C" int sunet_wmsa_ctx(const void* xw, void* ctx, const void* wqkv, const void* bqkv,
                              const void* bias, const void* mask, int T, int nW, int N, int C,
                              int heads, float scale, void* stream) {
  if (N % 16 || N > 64 || C % 16 || C % heads || nW < 1 || T % nW)
    return (int)cudaErrorInvalidValue;
  WinAttnArgs a{(const bf16*)xw,    (bf16*)ctx,         (const bf16*)wqkv, (const float*)bqkv,
                (const float*)bias, (const float*)mask, T,                 nW,
                N,                  C,                  heads,             scale};
  const size_t smem = win_attn_smem_bytes(N, C, align_up(C / heads, 16));
  cudaError_t e = set_smem(wmsa_ctx_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  wmsa_ctx_kernel<<<dim3(T, heads), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
