// Whole Swin block, one CTA per (image, window): the residual-saving
// training forward.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_swin_block_res
// (its kernel _block_fwd_res_kernel). The inference block and its train
// form (fused_swin_block, #1, and the chain #2) moved to swin_cluster.cu;
// this kernel serves the residual form alone, bit for bit
// as it was. LN1 -> window partition -> QKV -> per head QK^T*scale +
// rel-pos bias (+ SW mask) -> row-max softmax -> P@V -> proj -> residual ->
// LN2 -> fc1 -> erf GELU -> fc2 -> residual, each image's two branches
// scaled by its stochastic-depth pair dp[b] = (s1, s2): y = round(x +
// s1*attn), out = round(y + s2*mlp). Each head's softmax denominator is the
// sum of the bf16-rounded exponentials, ctx_f = (e_bf16 @ v) * (1/den), the
// block goes on from round(ctx_f), and the kernel also stores the attention
// state that swin_block_bwd_res.cu differentiates, in window-major (rolled)
// token order: eb (B*nW, heads, N, N) bf16, rden (B*nW, heads, N) and ctx_f
// (T, C) float32. Those stores add ~9 KB per head-window at N=64 to the
// kernel's HBM traffic.
//
// What bounds it on Hopper: at C=96..192 a 64-token window holds ~16 MFLOP
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
// C=384. The fc2 sums (64 x C fp32) stay in registers: each warp owns up to
// 3 output column tiles for all 4 row tiles. Products are bf16 wmma tiles
// with fp32 accumulation, register-tiled per warp (4 rows x up to 3
// columns), weight tiles read straight from L2.
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
  const float* dp;   // (B, 2) drop-path scales of the two branches, or null (ones)
  int B, H, W, C, hidden, ws, heads, shift;
  float scale;
  AttnRes res;       // the residual route's stores, whole-batch bases
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
  // scales of the attention and MLP branches (stochastic depth); 1 exactly
  // leaves every rounding of the inference block unchanged
  const float s1 = a.dp ? a.dp[2 * b] : 1.f, s2 = a.dp ? a.dp[2 * b + 1] : 1.f;
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
  const size_t wg = (size_t)b * gridDim.x + win;   // window-major window index
  const AttnRes res{a.res.eb + wg * a.heads * N * N, a.res.rden + wg * a.heads * N,
                    a.res.ctx + wg * N * C};
  for (int hh = 0; hh < a.heads; ++hh)
    attn_head<true>(xn, ldx, C, N, d, dp, hh, a.wqkv, a.bqkv, a.bias, mask, a.scale, hs,
                    bt, stg, warp, lane,
                    [&](int t, int c, bf16 v) { ctx[t * ldx + c] = v; }, res);
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
          xs[e] = tobf(bf(xs[e]) + s1 * (v + a.bproj[ct * 16 + c]));  // y = x + s1*attn
        });
      }
    }
  }
  __syncthreads();

  // ---- MLP sublayer
  layer_norm_rows(xs, xn, ldx, N, C, a.g2, a.be2, warp, lane);
  __syncthreads();
  mlp_rows<kMR, MC>(xn, xs, ldx, ctx, N, C, a.hidden, a.w1, a.b1, a.w2, a.b2, s2, bt, stg,
                    warp, lane, [&](int t, int c, bf16 v) { a.out[tok[t] + c] = v; });
}

cudaError_t launch_block(const BlockArgs& a, cudaStream_t st) {
  const int N = a.ws * a.ws;
  if (N % 16 || N > 64 || a.C % 16 || a.C % a.heads || a.hidden % 16 || a.H % a.ws ||
      a.W % a.ws)
    return cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(N, a.C, align_up(a.C / a.heads, 16));
  const dim3 grid((a.H / a.ws) * (a.W / a.ws), a.B);
  const int need = (a.C / 16 + kWarps - 1) / kWarps;
  return dispatch_mc<3>(need, [&](auto mc) -> cudaError_t {
    auto k = swin_block_kernel<decltype(mc)::value>;
    cudaError_t e = set_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
  });
}

}  // namespace sunet

using namespace sunet;

// The residual route's training forward: x, out, ln1 g/b, wqkv, bqkv,
// wproj, bproj, ln2 g/b, w1, b1, w2, b2, bias, mask, dp; then eb, rden and
// ctx_f (layouts in the header note); then the shape, scale and stream.
extern "C" int sunet_swin_block_res(const void* x, void* out, const void* g1,
                                    const void* be1, const void* wqkv, const void* bqkv,
                                    const void* wproj, const void* bproj, const void* g2,
                                    const void* be2, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* bias,
                                    const void* mask, const void* dp, void* eb, void* rden,
                                    void* ctx, int B, int H, int W, int C, int hidden, int ws,
                                    int heads, int shift, float scale, void* stream) {
  if (eb == nullptr || rden == nullptr || ctx == nullptr) return (int)cudaErrorInvalidValue;
  BlockArgs a{(const bf16*)x,     (bf16*)out,         (const float*)g1,
              (const float*)be1,  (const bf16*)wqkv,  (const float*)bqkv,
              (const bf16*)wproj, (const float*)bproj, (const float*)g2,
              (const float*)be2,  (const bf16*)w1,    (const float*)b1,
              (const bf16*)w2,    (const float*)b2,   (const float*)bias,
              (const float*)mask, (const float*)dp, B, H, W, C, hidden, ws, heads, shift,
              scale, AttnRes{(bf16*)eb, (float*)rden, (float*)ctx}};
  return (int)launch_block(a, (cudaStream_t)stream);
}
