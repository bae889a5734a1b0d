// LN + window partition + W-MSA + reverse + proj, no residual: three
// launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_window_attention
// on the blocks the whole-block kernel does not take (C=768 at the 8x8
// bottleneck of the default model, where one window holds the whole map;
// head dims above 64, e.g. C=384 with 2 heads). Rounding points as the JAX
// kernel: LN in fp32, rounded; qkv = round(xn @ wqkv + bqkv), q =
// round(q * scale); s = q k^T + bias (+ mask) in fp32, row-max softmax;
// ctx = round((round(e) @ v) / sum(e)); out = round(ctx @ wproj + bproj).
//
// What bounds it on Hopper: at batch 4 (8,8,768) the products are 1.26
// GFLOP (1.3 us at the bf16 peak) against 4.7 MB of bf16 weights and 0.8 MB
// of activations (1.6 us at 3.35 TB/s): the bytes. The attention itself is
// 6 MFLOP per window. A CTA per (window, head) that also ran its head's
// LayerNorm and products on 8 warps put 32 CTAs on 132 SMs at batch 4, each
// waiting on its own weight loads from L2.
//
// Design (ln_mlp.cu's pattern, #4): the products spread over the card, the
// attention stays small.
// 1. LN + qkv: gemm_tile.cuh's GEMM on 64-row x 128-column tiles, each CTA
//    computing the LayerNorm of its 64 rows on the way into its A operand
//    (kLnA: a launch fewer than a separate LN row kernel, whose time is
//    latency alone at these sizes), epilogue kEpiQkv (bias, then q scaled
//    and rounded again); split over K on a cluster of ksq CTAs where the
//    plan says so (kernels/window_attention.py::wmsa_plan, from one image's
//    shape: 1 at the default model's (8,8,768), 72 CTAs at batch 4, since a
//    split of 2 (144 CTAs) runs two waves on 132 SMs).
// 2. Attention (wmsa_attn.cuh, shared with the standalone W-MSA #15): one
//    CTA of four warps per (window, head), a warp per 16-row strip; q, k
//    and v come from qkv's token rows (the window partition is addressing)
//    into shared memory in chunks of 96 head columns, all three loads in
//    flight at once (cp.async for q and k); scores, softmax and P in
//    registers (mma.sync m16n8k16), ctx written at the tokens' own rows
//    (the reverse is addressing too). Windows of 256 tokens (the scaled
//    config's C=720 and C=1440 stages, head dim 30) take the big form: a
//    CTA per 64 query rows, two passes over the keys (wmsa_attn.cuh).
// 3. The projection: the same GEMM (kEpiBias), split over K on a cluster of
//    ks CTAs summed in rank order before bproj and the one rounding (4 at
//    the default model's (8,8,768): 96 CTAs at batch 4).
#include "wmsa_attn.cuh"

using namespace sunet;

extern "C" size_t sunet_ln_wmsa_workspace(int M, int C) { return wmsa::carve(nullptr, M, C).bytes; }

// out (B, H, W, C) = round(proj(W-MSA(round(LN(x)))) + bproj), x pre-rolled;
// ksq, ks: the K splits of the qkv product and the projection (their
// cluster sizes, from the launch plan).
extern "C" int sunet_ln_wmsa(const void* x, void* out, const void* g, const void* be,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* bias, const void* mask, void* work,
                             int B, int H, int W, int C, int ws, int heads, float scale, int ksq,
                             int ks, int* launches, void* stream) {
  const int N = ws * ws, M = B * H * W;
  if (C % 16 || C > 256 * kLnChunks || heads < 1 || C % heads || H % ws || W % ws || M <= 0 ||
      !wmsa::attn_takes(N, C / heads))
    return (int)cudaErrorInvalidValue;
  if (ksq < 1 || C % (16 * ksq) || kGemmCols % ksq || ks < 1 || C % (16 * ks) || kGemmCols % ks)
    return (int)cudaErrorInvalidValue;
  const wmsa::Work w = wmsa::carve((unsigned char*)work, M, C);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  SUNET_TRY((gemm_tile<kEpiQkv, true, true>(
      GemmArgs{(const bf16*)x, (const float*)bqkv, nullptr, w.qkv, M, C, C / ksq, 3 * C, ksq,
               scale, C, (const float*)g, (const float*)be},
      wqkv, st)));
  ++*launches;
  const wmsa::AttnArgs aa{w.qkv, w.ctx, (const float*)bias, (const float*)mask, H, W, C, ws,
                          heads};
  SUNET_TRY(wmsa::launch_attn(aa, B, st, launches));
  SUNET_TRY((gemm_tile<kEpiBias, true>(
      GemmArgs{w.ctx, (const float*)bproj, nullptr, (bf16*)out, M, C, C / ks, C, ks, 0.f, 0},
      wproj, st)));
  ++*launches;
  return 0;
}
