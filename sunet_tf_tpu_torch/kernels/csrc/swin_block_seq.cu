// The whole Swin block for windows above 64 tokens (WIN 16: 256, the scaled
// config's C=180 and C=360 stages), and the train form of the blocks up to
// 64 tokens a window that swin_cluster.cu does not take (C above 384, a head
// dim above 64, no cluster size: the default model's C=768 stage, head dim
// 96): five launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_swin_block (and
// fused_swin_block_chain, which launches it per block) where the window
// does not fit swin_cluster.cu's one 64-row wgmma tile per window. The
// rounding points are the JAX kernel body's (_block_body): LN1 in fp32,
// rounded; qkv = round(xn @ wqkv + bqkv), q = round(q * scale); s = q k^T +
// bias (+ mask) in fp32, row-max softmax, ctx = round((round(e) @ v) /
// sum(e)); y = round(x + (ctx @ wproj + bproj)) with the projection in fp32
// (the residual added to the accumulator, one rounding); h =
// round(gelu(round(LN2(y)) @ w1 + b1)); out = round(y + (h @ w2 + b2)).
//
// What bounds it on Hopper: at batch 8 (128,128,180), 6 heads of 256
// tokens, the products are 2 T C (3C + C + 2 * 4C) = 102 GFLOP and the
// attention 4 T N C = 24 GFLOP (0.13 ms at the bf16 peak) against 94 MB of
// activations in and out (0.03 ms at 3.35 TB/s): the operations.
//
// Design: launches on gemm_tile.cuh's token-row GEMM (64-row x 128-column
// tiles on hopper.cuh's TMA ring and wgmma, a K split on a cluster where the
// plan says so, kernels/window_attention.py::block_seq_plan) and the big
// form of wmsa_attn.cuh's attention, in the token map rolled by -shift: the
// SW-MSA roll is row addressing (GemmArgs::roll), no rolled copy exists.
// 1. LN1 + qkv: A = round(LN1(x)) of the rolled rows, gathered (kRollA);
// 2. the attention over qkv's rolled map (a CTA per 64 query rows of a
//    (window, head), two passes over the keys), ctx at the rolled rows;
// 3. proj: y = round(x + (ctx @ wproj + bproj)), x gathered (kRollY), y at
//    the rolled rows;
// 4. LN2 + fc1: h = round(gelu(round(LN2(y)) @ w1 + b1));
// 5. fc2: out = round(y + (h @ w2 + b2)), stored at the unrolled rows
//    (kRollOut).
// The train form (dp, the (B, 2) per-image drop-path scales, not null:
// kernels/window_attention.py::SwinBlockTrainable above 64 tokens, and at
// 64 tokens where the cluster kernel refuses the block) scales
// the attention branch in 3 and the MLP branch in 5 by the row's image's
// scale, at swin_cluster.cu's train-form rounding points: y = round(x + s1
// (ctx @ wproj + bproj)), out = round(y + s2 (h @ w2 + b2)) (gemm_tile.cuh's
// kModeDrop; the inference launches keep kModeGeneral alone). Up to 64
// tokens a window (train form alone; JAX's inference cap there is 384,
// which the cluster kernel covers) the attention is wmsa_attn.cuh's
// 64-token kernel, #3's, at any head dim (96-column chunks): the other four
// launches do not depend on the window, and the SW roll stays row
// addressing of the whole map, the mask indexed by the rolled map's window.
// C=180 is not a whole number of k16 steps or 16-byte row units: the
// products run over Kp = 192 (A's pad columns zeros, W's pad rows TMA's
// zero fill), activation rows load in 8-byte chunks, and wqkv, wproj and w2
// come with their columns padded to multiples of 8 (544, 184, 184) by the
// caller; the activations stay (B, H, W, 180). qkv, ctx, y and h pass
// through the workspace (carve_seq), bf16.
#include "wmsa_attn.cuh"

namespace sunet {

struct SeqWork {
  bf16 *qkv, *ctx, *y, *h;
  size_t bytes;
};

inline SeqWork carve_seq(unsigned char* p, int M, int C, int hidden) {
  Carve cv{p};
  SeqWork w;
  w.qkv = cv.take<bf16>((size_t)M * 3 * C);
  w.ctx = cv.take<bf16>((size_t)M * C);
  w.y = cv.take<bf16>((size_t)M * C);
  w.h = cv.take<bf16>((size_t)M * hidden);
  w.bytes = cv.used;
  return w;
}

inline bool split_ok(int K, int ks) { return ks >= 1 && K % (16 * ks) == 0 && kGemmCols % ks == 0; }

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_swin_block_seq_workspace(int M, int C, int hidden) {
  return carve_seq(nullptr, M, C, hidden).bytes;
}

// out (B, H, W, C), x unrolled (caller coordinates); mask (nW, N, N) in
// rolled coordinates or NULL; wqkv (C, 3C), wproj (C, C), w2 (hidden, C)
// with their columns padded to multiples of 8, w1 (C, hidden); Kp: the
// products' depth over C (a multiple of 16, C <= Kp < C + 64); ksq, ksp,
// ks1, ks2: the K splits of qkv, proj, fc1 and fc2 (from the launch plan);
// dp (B, 2) float32 or NULL (inference, windows above 64 tokens alone).
extern "C" int sunet_swin_block_seq(const void* x, void* out, const void* g1, const void* be1,
                                    const void* wqkv, const void* bqkv, const void* wproj,
                                    const void* bproj, const void* g2, const void* be2,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* bias, const void* mask,
                                    const void* dp, void* work, int B, int H, int W, int C, int hidden, int ws,
                                    int heads, int shift, float scale, int Kp, int ksq, int ksp,
                                    int ks1, int ks2, int* launches, void* stream) {
  const int N = ws * ws, M = B * H * W;
  if (B < 1 || C % 4 || C > (C % 8 ? 128 : 256) * kLnChunks || heads < 1 || C % heads ||
      hidden % 16 || H % ws || W % ws || (N <= wmsa::kTok && !dp) ||
      !wmsa::attn_takes(N, C / heads) ||
      shift < 0 || shift >= ws || Kp % 16 || Kp < C || Kp >= C + 64)
    return (int)cudaErrorInvalidValue;
  if (!split_ok(Kp, ksq) || !split_ok(Kp, ksp) || !split_ok(Kp, ks1) || !split_ok(hidden, ks2))
    return (int)cudaErrorInvalidValue;
  const SeqWork w = carve_seq((unsigned char*)work, M, C, hidden);
  cudaStream_t st = (cudaStream_t)stream;
  const int roll = shift ? 1 : 0;
  const int q3 = align_up(3 * C, 8), cc = align_up(C, 8);
  *launches = 0;
  // 1. LN1 + qkv over the rolled rows
  SUNET_TRY((gemm_tile_ks<kEpiQkv, true, kModeGeneral>(
      GemmArgs{(const bf16*)x, (const float*)bqkv, nullptr, w.qkv, M, C, Kp / ksq, 3 * C, ksq,
               scale, C, (const float*)g1, (const float*)be1, q3, roll * kRollA, H, W, shift},
      wqkv, st)));
  ++*launches;
  // 2. the attention over the rolled map
  const wmsa::AttnArgs aa{w.qkv, w.ctx, (const float*)bias, (const float*)mask, H, W, C, ws,
                          heads};
  SUNET_TRY(wmsa::launch_attn(aa, B, st, launches));
  // 3. proj + the residual x (gathered by the roll): y at the rolled rows
  const GemmArgs ga{w.ctx, (const float*)bproj, (const bf16*)x, w.y, M, C, Kp / ksp, C, ksp,
                    0.f, 0, nullptr, nullptr, cc, roll * kRollY, H, W, shift, (const float*)dp,
                    0};
  if (dp)
    SUNET_TRY((gemm_tile_ks<kEpiResid, false, kModeGeneral | kModeDrop>(ga, wproj, st)));
  else
    SUNET_TRY((gemm_tile_ks<kEpiResid, false, kModeGeneral>(ga, wproj, st)));
  ++*launches;
  // 4. LN2 + fc1 + GELU
  SUNET_TRY((gemm_tile_ks<kEpiGelu, true, kModeGeneral>(
      GemmArgs{w.y, (const float*)b1, nullptr, w.h, M, C, Kp / ks1, hidden, ks1, 0.f, 0,
               (const float*)g2, (const float*)be2},
      w1, st)));
  ++*launches;
  // 5. fc2 + the residual y: out at the unrolled rows
  const GemmArgs g2a{w.h, (const float*)b2, w.y, (bf16*)out, M, hidden, hidden / ks2, C, ks2,
                     0.f, 0, nullptr, nullptr, cc, roll * kRollOut, H, W, shift,
                     (const float*)dp, 1};
  if (dp)
    SUNET_TRY((gemm_tile_ks<kEpiResid, false, kModeGeneral | kModeDrop>(g2a, w2, st)));
  else
    SUNET_TRY((gemm_tile_ks<kEpiResid, false, kModeGeneral>(g2a, w2, st)));
  ++*launches;
  return 0;
}
