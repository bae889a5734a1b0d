// LN + window partition + W-MSA + reverse + proj, no residual.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_window_attention
// on the blocks above the whole-block cap (C=768 at the 8x8 bottleneck of
// the default model, where one window holds the whole map).
//
// What bounds it on Hopper: at batch 4 the bottleneck has 4 windows, so a
// CTA per window would leave 128 of 132 SMs idle; the per-window work (LN,
// q/k/v of 8 heads, 8 score tiles) is small against the 3.5 MB of bf16
// qkv+proj weights each CTA must stream from L2.
//
// Design: two kernels. (1) One CTA per (window, head): LN of the window's
// tokens into shared memory (97 KB at C=768), that head's q/k/v, scores,
// row-max softmax and P@V, written as ctx to a scratch (B, H, W, C) map at
// the tokens' own addresses, so the window reverse is addressing. That is
// B*nW*h CTAs (32 at batch 4) instead of B*nW, and each reads only its
// head's third of the qkv weights. (2) The output projection is a
// token-wise (B*H*W, C) x (C, C) product with bias, in 64x64 output tiles.
#include "common.cuh"

namespace sunet {

struct WmsaArgs {
  const bf16* x;
  bf16* ctx;
  const float* g;
  const float* be;
  const bf16* wqkv;
  const float* bqkv;
  const float* bias;
  const float* mask;
  int B, H, W, C, ws, heads;
  float scale;
};

// tok offsets | LN(x) | head | warps
__host__ __device__ inline size_t wmsa_smem_bytes(int N, int C, int dp) {
  return align128((size_t)N * 8) + align128((size_t)N * (C + kPad) * 2) +
         head_smem_bytes(N, dp) + warp_smem_bytes();
}

__global__ void __launch_bounds__(kThreads) ln_wmsa_ctx_kernel(WmsaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.ws * a.ws, C = a.C, d = C / a.heads, dp = align_up(d, 16);
  const int ldx = C + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  unsigned char* p = smem;
  long long* tok = reinterpret_cast<long long*>(p);
  p += align128((size_t)N * 8);
  bf16* xn = reinterpret_cast<bf16*>(p);
  p += align128((size_t)N * ldx * 2);
  const HeadSmem hs = carve_head(p, N, dp);
  p += head_smem_bytes(N, dp);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const int nwx = a.W / a.ws, win = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int wy = win / nwx, wx = win % nwx;
  for (int t = threadIdx.x; t < N; t += kThreads) {
    const int gy = wy * a.ws + t / a.ws, gx = wx * a.ws + t % a.ws;
    tok[t] = (((long long)b * a.H + gy) * a.W + gx) * C;
  }
  __syncthreads();
  const int cv = C / 8;
  for (int i = threadIdx.x; i < N * cv; i += kThreads) {
    const int t = i / cv, c8 = i % cv;
    reinterpret_cast<uint4*>(xn + t * ldx)[c8] =
        __ldg(reinterpret_cast<const uint4*>(a.x + tok[t]) + c8);
  }
  __syncthreads();
  layer_norm_rows(xn, xn, ldx, N, C, a.g, a.be, warp, lane);
  __syncthreads();
  const float* mask = a.mask ? a.mask + (size_t)win * N * N : nullptr;
  attn_head(xn, ldx, C, N, d, dp, hh, a.wqkv, a.bqkv, a.bias, mask, a.scale, hs, bt,
            stg, warp, lane,
            [&](int t, int c, bf16 v) { a.ctx[tok[t] + c] = v; });
}

// out[M x Nout] = round(A[M x K] @ W[K x Nout] + bias), 64x64 tiles per CTA,
// A straight from global memory. M, K, Nout multiples of 16.
__global__ void __launch_bounds__(kThreads)
    linear_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int M, int K, int Nout) {
  __shared__ __align__(128) unsigned char warp_buf[kWarps * 16 * (kBtLd * 2 + kStgLd * 4)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* bt;
  float* stg;
  carve_warp(warp_buf, warp, bt, stg);
  for (int t = warp; t < 16; t += kWarps) {
    const int row0 = blockIdx.x * 64 + (t / 4) * 16;
    const int col0 = blockIdx.y * 64 + (t % 4) * 16;
    if (row0 >= M || col0 >= Nout) continue;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    mma_block<1, 1>(&acc, A + (size_t)row0 * K, K, 1, Wt, Nout, 0, col0, 0, 1, 16, K, bt, lane);
    epilogue(acc, stg, lane, [&](int r, int c, float v) {
      out[(size_t)(row0 + r) * Nout + col0 + c] = tobf(v + bias[col0 + c]);
    });
  }
}

}  // namespace sunet

using namespace sunet;

// Kernel (1): ctx of every (window, head) into the (B, H, W, C) map `ctx`.
extern "C" int sunet_ln_wmsa_ctx(const void* x, void* ctx, const void* g, const void* be,
                                 const void* wqkv, const void* bqkv, const void* bias,
                                 const void* mask, int B, int H, int W, int C, int ws,
                                 int heads, float scale, void* stream) {
  const int N = ws * ws;
  if (N % 16 || N > 64 || C % 16 || C % heads || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  WmsaArgs a{(const bf16*)x, (bf16*)ctx, (const float*)g, (const float*)be,
             (const bf16*)wqkv, (const float*)bqkv, (const float*)bias,
             (const float*)mask, B, H, W, C, ws, heads, scale};
  const size_t smem = wmsa_smem_bytes(N, C, align_up(C / heads, 16));
  cudaError_t e = set_smem(ln_wmsa_ctx_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ln_wmsa_ctx_kernel<<<dim3((H / ws) * (W / ws), heads, B), kThreads, smem,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel (2): out (M, Nout) = round(A (M, K) @ W (K, Nout) + bias).
extern "C" int sunet_linear_bias(const void* A, const void* Wt, const void* bias, void* out,
                                 int M, int K, int Nout, void* stream) {
  if (M % 16 || K % 16 || Nout % 16) return (int)cudaErrorInvalidValue;
  linear_bias_kernel<<<dim3((M + 63) / 64, (Nout + 63) / 64), kThreads, 0,
                       (cudaStream_t)stream>>>((const bf16*)A, (const bf16*)Wt,
                                               (const float*)bias, (bf16*)out, M, K, Nout);
  return (int)cudaGetLastError();
}
