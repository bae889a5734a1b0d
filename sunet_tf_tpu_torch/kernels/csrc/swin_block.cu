// Whole Swin block, one CTA per (image, window).
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_swin_block (and,
// launched K times, fused_swin_block_chain): LN1 -> window partition -> QKV
// -> per head QK^T*scale + rel-pos bias (+ SW mask) -> row-max softmax -> P@V
// -> proj -> residual -> LN2 -> fc1 -> erf GELU -> fc2 -> residual.
//
// What bounds it on Hopper: at C=96..384 a 64-token window holds ~16 MFLOP
// of products against ~0.1-0.3 MB of (L2-resident) weights read per CTA, so
// the weight stream from L2 and the tensor-core issue rate bound it, not
// HBM: the activation crosses device memory once in and once out.
//
// Design: the whole block is window-local, so one CTA owns one window and
// nothing leaves the SM between the sublayers. The SW-MSA roll and the
// partition/reverse are load/store addressing (rolled token (r, c) of window
// (wy, wx) lives at x[b, (wy*ws+r+s) % H, (wx*ws+c+s) % W]); the mask row is
// the window's rolled-space index. Shared memory (227 KB) holds x, LN(x) and
// ctx for the window plus one head's q/k/v and scores: 215,808 bytes at
// C=384, which is the cap (kernels/window_attention.py BLOCK_KERNEL_MAX_C).
// The fc2 sums (64 x C fp32, 96 KB at C=384) stay in registers: each warp
// owns up to 3 output column tiles for all 4 row tiles. Products are bf16
// wmma tiles with fp32 accumulation, register-tiled per warp (4 rows x up
// to 3 columns), weight tiles read straight from L2 (wgmma/TMA are later
// work).
#include "common.cuh"

namespace sunet {

struct BlockArgs {
  const bf16* x;
  bf16* out;
  const float* g1;
  const float* be1;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const float* bproj;
  const float* g2;
  const float* be2;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* bias;
  const float* mask;
  int B, H, W, C, hidden, ws, heads, shift;
  float scale;
};

// tok offsets | x | LN(x) | ctx (then the MLP hidden chunk) | head | warps;
// the window's token rows have stride C + kPad.
__host__ __device__ inline size_t block_smem_bytes(int N, int C, int dp) {
  const int ldx = C + kPad;
  return align128((size_t)N * 8) + 2 * align128((size_t)N * ldx * 2) +
         align128((size_t)N * (ldx > kHB ? ldx : kHB) * 2) + head_smem_bytes(N, dp) +
         warp_smem_bytes();
}

template <int MC>
__global__ void __launch_bounds__(kThreads) swin_block_kernel(BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.ws * a.ws, C = a.C, d = C / a.heads, dp = align_up(d, 16);
  const int ldx = C + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  unsigned char* p = smem;
  long long* tok = reinterpret_cast<long long*>(p);
  p += align128((size_t)N * 8);
  bf16* xs = reinterpret_cast<bf16*>(p);
  p += align128((size_t)N * ldx * 2);
  bf16* xn = reinterpret_cast<bf16*>(p);
  p += align128((size_t)N * ldx * 2);
  bf16* ctx = reinterpret_cast<bf16*>(p);
  p += align128((size_t)N * (ldx > kHB ? ldx : kHB) * 2);
  const HeadSmem hs = carve_head(p, N, dp);
  p += head_smem_bytes(N, dp);
  bf16* bt;
  float* stg;
  carve_warp(p, warp, bt, stg);

  const int nwx = a.W / a.ws, win = blockIdx.x, b = blockIdx.y;
  const int wy = win / nwx, wx = win % nwx;
  for (int t = threadIdx.x; t < N; t += kThreads) {
    const int gy = (wy * a.ws + t / a.ws + a.shift) % a.H;
    const int gx = (wx * a.ws + t % a.ws + a.shift) % a.W;
    tok[t] = (((long long)b * a.H + gy) * a.W + gx) * C;
  }
  __syncthreads();
  const int cv = C / 8;
  for (int i = threadIdx.x; i < N * cv; i += kThreads) {
    const int t = i / cv, c8 = i % cv;
    reinterpret_cast<uint4*>(xs + t * ldx)[c8] =
        __ldg(reinterpret_cast<const uint4*>(a.x + tok[t]) + c8);
  }
  __syncthreads();

  // ---- attention sublayer
  layer_norm_rows(xs, xn, ldx, N, C, a.g1, a.be1, warp, lane);
  __syncthreads();
  const float* mask = a.mask ? a.mask + (size_t)win * N * N : nullptr;
  for (int hh = 0; hh < a.heads; ++hh)
    attn_head(xn, ldx, C, N, d, dp, hh, a.wqkv, a.bqkv, a.bias, mask, a.scale, hs,
              bt, stg, warp, lane,
              [&](int t, int c, bf16 v) { ctx[t * ldx + c] = v; });
  const int rt_n = N / 16, nc = owned(C / 16, warp);
  if (nc > 0) {
    FragC acc[kMR * MC];
    zero(acc);
    mma_block<kMR, MC>(acc, ctx, ldx, rt_n, a.wproj, C, 0, warp * 16, kWarps * 16, nc,
                       16, C, bt, lane);
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        if (i >= rt_n || j >= nc) continue;
        const int ct = warp + j * kWarps;
        epilogue(acc[i * MC + j], stg, lane, [&](int r, int c, float v) {
          const int e = (i * 16 + r) * ldx + ct * 16 + c;
          xs[e] = tobf(bf(xs[e]) + (v + a.bproj[ct * 16 + c]));  // y = x + attn
        });
      }
    }
  }
  __syncthreads();

  // ---- MLP sublayer
  layer_norm_rows(xs, xn, ldx, N, C, a.g2, a.be2, warp, lane);
  __syncthreads();
  mlp_rows<kMR, MC>(xn, xs, ldx, ctx, N, C, a.hidden, a.w1, a.b1, a.w2, a.b2, bt, stg,
                 warp, lane, [&](int t, int c, bf16 v) { a.out[tok[t] + c] = v; });
}

}  // namespace sunet

using namespace sunet;

extern "C" int sunet_swin_block(const void* x, void* out, const void* g1,
                                const void* be1, const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj, const void* g2,
                                const void* be2, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* bias,
                                const void* mask, int B, int H, int W, int C,
                                int hidden, int ws, int heads, int shift, float scale,
                                void* stream) {
  BlockArgs a{(const bf16*)x,     (bf16*)out,         (const float*)g1,
              (const float*)be1,  (const bf16*)wqkv,  (const float*)bqkv,
              (const bf16*)wproj, (const float*)bproj, (const float*)g2,
              (const float*)be2,  (const bf16*)w1,    (const float*)b1,
              (const bf16*)w2,    (const float*)b2,   (const float*)bias,
              (const float*)mask, B, H, W, C, hidden, ws, heads, shift, scale};
  const int N = ws * ws;
  if (N % 16 || N > 64 || C % 16 || C % heads || hidden % 16 || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(N, C, align_up(C / heads, 16));
  const dim3 grid((H / ws) * (W / ws), B);
  const int need = (C / 16 + kWarps - 1) / kWarps;
  return (int)dispatch_mc<3>(need, [&](auto mc) -> cudaError_t {
    auto k = swin_block_kernel<decltype(mc)::value>;
    cudaError_t e = set_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}
