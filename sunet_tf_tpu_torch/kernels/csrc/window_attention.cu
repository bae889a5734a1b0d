// W-MSA over pre-partitioned windows: qkv with bias, attention, the output
// projection, no LayerNorm: three launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::wmsa_core (its kernel
// _kernel), behind fused_window_attention: from windows xw (T, N, C), T =
// B * nW in image-major order, it writes out (T, N, C). Rounding points (the
// JAX kernel's): qkv accumulated in fp32 + bias, rounded; q*scale rounded;
// scores fp32 + rel-pos bias (+ the additive mask of window t % nW); exact
// row-max softmax, P rounded, the divide after P@V; ctx rounded; the
// projection accumulated in fp32 + bias, rounded.
//
// What bounds it on Hopper: at (64,64,96) batch 2 with 8 heads and ws 8 the
// products are 0.8 GFLOP and the bytes 3.2 MB (x in, out, bf16 weights):
// ~1 us, the bytes bound. A CTA per (window, head) that also ran its head's
// q, k and v products streamed the q/k/v weights from L2 into every one of
// its 1024 CTAs.
//
// Design: the LN+W-MSA kernel's three launches (ln_window_attention.cu, #3)
// without the LayerNorm: the products spread over the card, the attention
// stays small.
// 1. qkv: gemm_tile.cuh's GEMM on 64-row x 128-column tiles of the T * N
//    token rows (xw's rows are already token rows: A is a plain copy),
//    epilogue kEpiQkv (bias, then q scaled and rounded again), split over
//    K on a cluster of ksq CTAs where the plan says so.
// 2. Attention: wmsa_attn.cuh's kernel, one CTA per (window, head), token i
//    of window t at row t * N + i, the mask that of window t % nW.
// 3. The projection: the same GEMM (kEpiBias), split over K on a cluster of
//    ks CTAs summed in rank order before bproj and the one rounding.
// ksq and ks come from kernels/window_attention.py::wmsa_plan over one
// image's windows side by side (an (ws, nW * ws) map): never the batch.
// qkv and ctx pass through the workspace (wmsa::carve), bf16.
#include "wmsa_attn.cuh"

using namespace sunet;

// out (T, N, C) = round(proj(W-MSA(xw)) + bproj) over T windows of N = ws *
// ws tokens, nW windows per image; bqkv (3C) must be given (zeros for none);
// ksq, ks: the K splits of the qkv product and the projection (their
// cluster sizes, from the launch plan); the workspace is
// sunet_ln_wmsa_workspace(T * N, C) bytes.
extern "C" int sunet_wmsa_core(const void* xw, void* out, const void* wqkv, const void* bqkv,
                               const void* wproj, const void* bproj, const void* bias,
                               const void* mask, void* work, int T, int nW, int ws, int C,
                               int heads, float scale, int ksq, int ks, int* launches,
                               void* stream) {
  const int N = ws * ws, M = T * N;
  if (N % 16 || N > wmsa::kTok || C % 16 || C % heads || nW < 1 || T < 1 || T % nW)
    return (int)cudaErrorInvalidValue;
  if (ksq < 1 || C % (16 * ksq) || kGemmCols % ksq || ks < 1 || C % (16 * ks) || kGemmCols % ks)
    return (int)cudaErrorInvalidValue;
  const wmsa::Work w = wmsa::carve((unsigned char*)work, M, C);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  const float* bq = (const float*)bqkv;
  SUNET_TRY((gemm_tile<kEpiQkv, true>(
      GemmArgs{(const bf16*)xw, bq, nullptr, w.qkv, M, C, C / ksq, 3 * C, ksq, scale, C},
      wqkv, st)));
  ++*launches;
  const wmsa::AttnArgs aa{w.qkv, w.ctx, (const float*)bias, (const float*)mask, ws, nW * ws, C,
                          ws, heads};
  wmsa::attn_kernel<true><<<dim3(nW, heads, T / nW), wmsa::kAttnThreads, 0, st>>>(aa);
  SUNET_TRY(launched(launches));
  SUNET_TRY((gemm_tile<kEpiBias, true>(
      GemmArgs{w.ctx, (const float*)bproj, nullptr, (bf16*)out, M, C, C / ks, C, ks, 0.f, 0},
      wproj, st)));
  ++*launches;
  return 0;
}
