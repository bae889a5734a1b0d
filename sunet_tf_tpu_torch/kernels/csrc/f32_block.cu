// The float32 forms of the split sublayer kernels: LN + W-MSA + projection
// (#3) and LN + MLP + residual (#4), for a float32 model
// (TPU.COMPUTE_DTYPE: float32); the whole block (#1, #2) is
// csrc/f32_swin_block.cu.
//
// Replace, in float32, sunet_tf_tpu/kernels/window_attention.py::
// fused_ln_window_attention (#3) and fused_ln_mlp (#4), whose Pallas bodies
// compute in x's dtype: in float32 every intermediate (LN output, q/k/v,
// probabilities, context, hidden) stays float32, LayerNorm statistics,
// softmax (row max) and sums are float32, GELU is the exact erf form.
//
// What bounds them on Hopper: the products in float32, on the CUDA cores
// (FFMA, 67 TFLOP/s). At the default model's C=768 the map is one 8 x 8
// window an image, so a form runs as launches of f32_tile.cuh's token-row
// product over every image's rows, its intermediates (q/k/v, context,
// hidden) in a device workspace (L2-resident at these sizes), with a
// float32 attention kernel per (window, head) between them:
//
//   #3 (3 launches): LN + qkv (A = x's rows through the window partition as
//      addressing), attention, proj + bias written to the window's NHWC
//      rows (no residual; x rolled by the caller);
//   #4 (3 launches): the LN statistics of y's rows (ln_stats), fc1 + GELU
//      on LN(y) (the statistics read, not recomputed by each of fc1's
//      column tiles), fc2 + b2 + the residual y.
//
// Every output element is one thread's sum in one order and no launch
// splits K: the same bits at any batch and every run.
#include "f32_tile.cuh"

namespace f32 {

constexpr int kAttnThreads = 256;

// Dynamic shared memory of the attention kernel: q * scale and k
// transposed (d rows of N), v (N rows of d), the scores (N rows of N + 1)
// and the row sums.
inline size_t attn_smem(int N, int d) {
  return (size_t)(3 * d * N + N * (N + 1) + N) * sizeof(float);
}

// ctx (windows x N, C) of qkv (windows x N, 3C), one CTA per (head, window):
// s = (q * scale) k^T + bias[head] (+ mask[window % nW]); e = exp(s -
// rowmax); ctx = (e @ v) / max(sum e, 1e-37).
__global__ void __launch_bounds__(kAttnThreads)
attn_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, const float* __restrict__ bias,
            const float* __restrict__ mask, int N, int C, int heads, int nW, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int d = C / heads, h = blockIdx.x;
  const long long win = blockIdx.y;
  float* Qt = sm;
  float* Kt = Qt + d * N;
  float* V = Kt + d * N;
  float* S = V + N * d;
  float* den = S + N * (N + 1);
  const int tid = threadIdx.x;
  const long long base = win * N;
  for (int e = tid; e < N * d; e += kAttnThreads) {
    const int i = e / d, c = e % d;
    const float* row = qkv + (base + i) * 3 * C + h * d + c;
    Qt[c * N + i] = row[0] * scale;
    Kt[c * N + i] = row[C];
    V[i * d + c] = row[2 * C];
  }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  if (ty * 4 < N && tx * 4 < N) {
    float s[4][4] = {};
    for (int c = 0; c < d; ++c) {
      const float4 q4 = *reinterpret_cast<const float4*>(&Qt[c * N + ty * 4]);
      const float4 k4 = *reinterpret_cast<const float4*>(&Kt[c * N + tx * 4]);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    const float* bh = bias + (size_t)h * N * N;
    const float* mw = mask ? mask + (size_t)(win % nW) * N * N : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx * 4 + j;
        float v = s[i][j] + bh[r * N + c];
        if (mw) v = v + mw[r * N + c];
        S[r * (N + 1) + c] = v;
      }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < N; r += kAttnThreads / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, S[r * (N + 1) + j]);
    mx = sunet::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(S[r * (N + 1) + j] - mx);
      S[r * (N + 1) + j] = e;
      sum += e;
    }
    sum = sunet::warp_sum(sum);
    if (lane == 0) den[r] = fmaxf(sum, 1e-37f);
  }
  __syncthreads();
  for (int e = tid; e < N * d; e += kAttnThreads) {
    const int i = e / d, c = e % d;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(S[i * (N + 1) + j], V[j * d + c], acc);
    ctx[(base + i) * C + h * d + c] = acc / den[i];
  }
}

inline cudaError_t attention(const float* qkv, float* ctx, const float* bias, const float* mask,
                             long long windows, int N, int C, int heads, int nW, float scale,
                             cudaStream_t stream) {
  const size_t smem = attn_smem(N, C / heads);
  cudaError_t err = sunet::set_smem(attn_kernel, smem);
  if (err != cudaSuccess) return err;
  if (windows > 65535) return cudaErrorInvalidValue;
  attn_kernel<<<dim3(heads, (unsigned)windows), kAttnThreads, smem, stream>>>(
      qkv, ctx, bias, mask, N, C, heads, nW, scale);
  return cudaGetLastError();
}

// The window forms' shape rule: C a multiple of 16 and of heads, windows of
// N = ws^2 tokens, N a multiple of 16 up to 64, the map a whole number of
// windows, the attention's shared memory within the card's.
inline bool window_takes(int H, int W, int C, int ws, int heads) {
  const int N = ws * ws;
  return C > 0 && C % 16 == 0 && heads > 0 && C % heads == 0 && N % 16 == 0 && N <= 64 &&
         H % ws == 0 && W % ws == 0 && attn_smem(N, C / heads) <= sunet::kMaxSmem;
}

struct Work {
  float *qkv, *ctx;
  size_t bytes;
};

inline Work carve(unsigned char* p, long long M, int C) {
  Work w{};
  w.qkv = reinterpret_cast<float*>(p);
  const size_t qkv = sunet::align128((size_t)M * 3 * C * sizeof(float));
  w.ctx = reinterpret_cast<float*>(p + qkv);
  w.bytes = qkv + sunet::align128((size_t)M * C * sizeof(float));
  return w;
}

}  // namespace f32

using namespace f32;

extern "C" size_t sunet_f32_ln_wmsa_workspace(int M, int C) { return carve(nullptr, M, C).bytes; }

// out (B, H, W, C) = proj(W-MSA(LN(x))) + bproj over x rolled by the
// caller, float32 throughout. 3 launches.
extern "C" int sunet_f32_ln_wmsa(const void* x, void* out, const void* g, const void* be,
                                 const void* wqkv, const void* bqkv, const void* wproj,
                                 const void* bproj, const void* bias, const void* mask,
                                 void* work, int B, int H, int W, int C, int ws, int heads,
                                 float scale, int* launches, void* stream) {
  if (!window_takes(H, W, C, ws, heads) || B <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)B * H * W;
  const Work w = carve((unsigned char*)work, M, C);
  const RowMap map = windows(H, W, ws, 0);
  // qkv = LN(x's window rows) @ wqkv + bqkv, then the attention's ctx
  Gemm qkv = product((const float*)x, C, (const float*)wqkv, 3 * C, (const float*)bqkv, w.qkv,
                     3 * C, M, 3 * C, C);
  qkv.amap = map;
  qkv.ln_g = (const float*)g;
  qkv.ln_b = (const float*)be;
  cudaError_t err = gemm(qkv, s);
  if (err != cudaSuccess) return err;
  const int N = ws * ws;
  err = attention(w.qkv, w.ctx, (const float*)bias, (const float*)mask, M / N, N, C, heads,
                  (H / ws) * (W / ws), scale, s);
  if (err != cudaSuccess) return err;
  Gemm proj = product(w.ctx, C, (const float*)wproj, C, (const float*)bproj, (float*)out, C, M,
                      C, C);
  proj.omap = map;
  err = gemm(proj, s);
  *launches = 3;
  return err;
}

extern "C" size_t sunet_f32_ln_mlp_workspace(int M, int hidden) {
  return sunet::align128((size_t)M * hidden * sizeof(float)) +
         sunet::align128((size_t)M * 2 * sizeof(float));
}

// out (M, C) = y + fc2(gelu(fc1(LN(y)) + b1)) + b2, float32 throughout.
// 3 launches.
extern "C" int sunet_f32_ln_mlp(const void* y, void* out, const void* g, const void* be,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* work, int M, int C, int hidden, int* launches,
                                void* stream) {
  if (M <= 0 || C <= 0 || C % 16 || hidden <= 0 || hidden % 16) return cudaErrorInvalidValue;
  RowMap rows{};
  rows.kind = kRows;
  cudaStream_t s = (cudaStream_t)stream;
  float* h = (float*)work;
  float* stats = (float*)((unsigned char*)work + sunet::align128((size_t)M * hidden * sizeof(float)));
  cudaError_t err = ln_stats((const float*)y, rows, C, M, C, stats, s);
  if (err != cudaSuccess) return err;
  // h = gelu(LN(y) @ w1 + b1), the statistics read; out = y + (h @ w2 + b2)
  Gemm up = product((const float*)y, C, (const float*)w1, hidden, (const float*)b1, h, hidden, M,
                    hidden, C);
  up.ln_g = (const float*)g;
  up.ln_b = (const float*)be;
  up.stats = stats;
  up.epi = kGelu;
  if ((err = gemm(up, s)) != cudaSuccess) return err;
  Gemm down = product(h, hidden, (const float*)w2, C, (const float*)b2, (float*)out, C, M, C,
                      hidden);
  down.epi = kResidual;
  down.res = (const float*)y;
  down.ldr = C;
  err = gemm(down, s);
  *launches = 3;
  return err;
}
