// y + fc2(gelu(fc1(LN(y)))) over token rows: three launches.
//
// Replaces sunet_tf_tpu/kernels/window_attention.py::fused_ln_mlp on the
// blocks above the whole-block cap (C=768, hidden 3072 at the bottleneck;
// the scaled config's C=720 / hidden 2880 and C=1440 / hidden 5760).
// Rounding points as the JAX kernel: LN in fp32, rounded; fc1 accumulated in
// fp32 plus b1, exact-erf GELU in fp32, rounded; out = round(y + (fc2 +
// b2)), fc2 accumulated in fp32.
//
// What bounds it on Hopper: at batch 4, 4*T*C*hidden = 2.4 GFLOP (2.4 us at
// the bf16 peak) against 9.4 MB of bf16 weights (2.8 us at 3.35 TB/s): the
// bytes. A kernel over 16-row tiles ran 16 CTAs at batch 4, each streaming
// all 9.4 MB from L2.
//
// Design (#13's sequence, ln_mlp_branch.cu, on gemm_tile.cuh's GEMM over
// hopper.cuh's mainloop):
// 1. the LayerNorm row kernel of train_common.cuh (ln_fwd) into yn;
// 2. fc1: one CTA per 64-row x 128-column tile (4 x 24 = 96 CTAs at batch
//    4), A = yn's 64 rows in shared memory, w1's boxes by TMA into the ring,
//    the two warpgroups one 64-column box each; the epilogue adds b1, applies
//    the erf GELU and stores h rounded. Where the 64 x C operand does not
//    fit shared memory (C=1440: 184 KB) it splits over K as fc2 does (KS1
//    from the plan, 2 at C=1440), the GELU after the rank-ordered sum;
// 3. fc2: a cluster of KS CTAs per 64-row x 128-column tile, each over hidden
//    / KS rows of w2 (KS from the launch plan, kernels/window_attention.py::
//    mlp_plan, from one image's rows: 4 for the default model's 8x8 map, 96
//    CTAs at batch 4); the fp32 partials meet in distributed
//    shared memory, and rank r sums its 128/KS columns in rank order, adds b2
//    and y and rounds once: the same bits every run.
// Rows past the end are zero-filled and not written.
#include "gemm_tile.cuh"

namespace sunet {

struct MlpWork {
  bf16 *yn, *h;
  float* st;
  size_t bytes;
};

inline MlpWork carve_mlp(unsigned char* p, int M, int C, int hidden) {
  Carve cv{p};
  MlpWork w;
  w.yn = cv.take<bf16>((size_t)M * C);
  w.h = cv.take<bf16>((size_t)M * hidden);
  w.st = cv.take<float>(2 * (size_t)M);
  w.bytes = cv.used;
  return w;
}

}  // namespace sunet

using namespace sunet;

extern "C" size_t sunet_ln_mlp_workspace(int M, int C, int hidden) {
  return carve_mlp(nullptr, M, C, hidden).bytes;
}

// out (M, C) = round(y + fc2(round(gelu(fc1(round(LN(y))) + b1))) + b2);
// ks1, ks: fc1's and fc2's K splits (their cluster sizes, from the launch
// plan).
extern "C" int sunet_ln_mlp(const void* y, void* out, const void* g, const void* be,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* work, int M, int C, int hidden, int ks1, int ks,
                            int* launches, void* stream) {
  if (M <= 0 || C % 16 || hidden % 16 || ks < 1 || hidden % (16 * ks) || kGemmCols % ks ||
      ks1 < 1 || C % (16 * ks1) || kGemmCols % ks1)
    return (int)cudaErrorInvalidValue;
  const MlpWork w = carve_mlp((unsigned char*)work, M, C, hidden);
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  SUNET_TRY(ln_fwd((const bf16*)y, false, nullptr, w.yn, w.st, (const float*)g,
                   (const float*)be, M, C, 0, 0, 0, 0, st, launches));
  const int kh = hidden / ks;
  SUNET_TRY((gemm_tile_ks<kEpiGelu>(
      GemmArgs{w.yn, (const float*)b1, nullptr, w.h, M, C, C / ks1, hidden, ks1, 0.f, 0}, w1,
      st)));
  ++*launches;
  SUNET_TRY((gemm_tile<kEpiResid, true>(
      GemmArgs{w.h, (const float*)b2, (const bf16*)y, (bf16*)out, M, hidden, kh, C, ks, 0.f, 0},
      w2, st)));
  ++*launches;
  return 0;
}
